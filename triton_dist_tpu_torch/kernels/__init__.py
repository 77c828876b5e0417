"""Hand-written Hopper kernels (csrc/) with their plain PyTorch versions.

B1 ``flash_attention.flash_prefill`` and B2
``paged_flash_decode.paged_flash_decode_partial`` are the kernels of the
paged serving path; ``flash_decode`` holds the LSE merge they feed."""
