"""Quantization: the kv_int8_row codec and the TD_QUANT policy parse."""
