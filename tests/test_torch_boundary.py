"""The port's import boundary: it never imports JAX or the JAX package.

The machine with the card has no JAX, and the port must run there, so a
fresh interpreter that imports the whole port must end with neither in
sys.modules, and no source file of the port may name them.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "triton_dist_tpu_torch"

_PROBE = """
import sys
import triton_dist_tpu_torch
import triton_dist_tpu_torch.models
import triton_dist_tpu_torch.layers.tp_attn
import triton_dist_tpu_torch.layers.tp_mlp
import triton_dist_tpu_torch.layers.tp_moe
import triton_dist_tpu_torch.models.qwen_moe
import triton_dist_tpu_torch.kernels
import triton_dist_tpu_torch.kernels.allgather
import triton_dist_tpu_torch.kernels.allgather_gemm
import triton_dist_tpu_torch.kernels.allreduce
import triton_dist_tpu_torch.kernels.reduce_scatter
import triton_dist_tpu_torch.runtime.native
import triton_dist_tpu_torch.kernels.allgather_group_gemm
import triton_dist_tpu_torch.kernels.gemm_reduce_scatter
import triton_dist_tpu_torch.kernels.moe_reduce_rs
import triton_dist_tpu_torch.kernels.moe_utils
import triton_dist_tpu_torch.kernels.flash_attention
import triton_dist_tpu_torch.kernels.paged_flash_decode
import triton_dist_tpu_torch.kernels.flash_decode
import triton_dist_tpu_torch.kernels.fused_chain
import triton_dist_tpu_torch.kernels.gemm_allreduce
import triton_dist_tpu_torch.mega.runtime
import triton_dist_tpu_torch.mega.models.qwen3
import triton_dist_tpu_torch.quant.codec
import triton_dist_tpu_torch.quant.contract
import triton_dist_tpu_torch.quant.policy
import triton_dist_tpu_torch.runtime.prng
import triton_dist_tpu_torch.kernels.quant_wire
import triton_dist_tpu_torch.kernels.kv_handoff
import triton_dist_tpu_torch.runtime.build
import triton_dist_tpu_torch.runtime.mesh
import triton_dist_tpu_torch.runtime.symm
import triton_dist_tpu_torch.language
import triton_dist_tpu_torch.models.weights
import triton_dist_tpu_torch.models.engine
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "triton_dist_tpu"
             or m.startswith("triton_dist_tpu."))
print("BAD=" + ",".join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD=\n" in res.stdout, res.stdout


def test_port_sources_never_name_jax_or_the_jax_package():
    pat = re.compile(r"\bjax\b|\bjaxlib\b|triton_dist_tpu(?!_torch)")
    files = sorted(p for p in PORT.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh", ".cc")
                   and "build" not in p.relative_to(PORT).parts)
    assert len(files) >= 20
    hits = [f"{p.relative_to(REPO)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert not hits, "\n".join(hits)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py runs on the machine with the cards, which has no
    JAX: none of its imports (top level or inside functions) names JAX or
    the JAX package."""
    import ast
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert any(n.startswith("triton_dist_tpu_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "jaxlib", "triton_dist_tpu")]
    assert not bad, bad


def test_port_host_sources_are_its_own():
    """The native schedule provider builds the port's own copies of the
    host C++ (triton_dist_tpu_torch/csrc/host/) into the port's build
    directory, and no source of the port points at the repository's root
    csrc/ (the JAX package's native sources)."""
    from triton_dist_tpu_torch.runtime import native
    assert native.sources(), "no host sources"
    for src in native.sources():
        assert src.resolve().is_relative_to(PORT / "csrc" / "host"), src
    assert native.library_path().resolve().is_relative_to(
        PORT / "csrc" / "build")
    root_csrc = re.compile(r"parent\.parent\.parent|\.\./csrc|"
                           r"REPO\s*/\s*[\"']csrc|libtriton_dist_tpu")
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if root_csrc.search(line)]
    assert not hits, hits
