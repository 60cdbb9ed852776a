"""The port stands alone: importing every lantern_tpu_torch module and
chip_smoke pulls in neither jax nor lantern_tpu, and an entry point given no
device on a machine without CUDA raises instead of running on the CPU."""

import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import lantern_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        lantern_tpu_torch.__path__, "lantern_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    import chip_smoke  # main() runs only under __main__
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "lantern_tpu", "flax"))
    assert not bad, bad
    assert len(mods) >= 21, mods
    assert {"lantern_tpu_torch.ops.hamming",
            "lantern_tpu_torch.quant.scalar",
            "lantern_tpu_torch.graph.build_device",
            "lantern_tpu_torch.graph.validate",
            "lantern_tpu_torch.graph.reorder"} <= set(mods), mods
    import torch
    from lantern_tpu_torch import HnswParams, Index
    if not torch.cuda.is_available():
        try:
            Index(HnswParams(dim=8))
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("Index without a device ran on the CPU")
    print("isolated", len(mods))
""")


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
