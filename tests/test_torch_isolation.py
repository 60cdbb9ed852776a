"""The port stands alone: importing every lantern_tpu_torch module and
chip_smoke pulls in neither jax, ml_dtypes nor lantern_tpu, and an entry
point, a service, a sharded layout (``parallel.make_mesh``, which every
``parallel`` entry point takes its device from) or a rank joining a
process group (``parallel.init_multihost``) given no device on a machine
without CUDA raises instead of running on the CPU; named the CPU, a
one-rank gloo group lays its shards out."""

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
                 if m.split(".")[0] in ("jax", "jaxlib", "lantern_tpu", "flax",
                                        "ml_dtypes"))
    assert not bad, bad
    assert len(mods) >= 50, mods
    assert {"lantern_tpu_torch.ops.hamming",
            "lantern_tpu_torch.quant.scalar",
            "lantern_tpu_torch.graph.build_device",
            "lantern_tpu_torch.graph.validate",
            "lantern_tpu_torch.graph.reorder",
            "lantern_tpu_torch.graph.host_build",
            "lantern_tpu_torch.storage.snapshot",
            "lantern_tpu_torch.storage.replica",
            "lantern_tpu_torch.utils.failpoints",
            "lantern_tpu_torch.utils.logger",
            "lantern_tpu_torch.io.dotvecs",
            "lantern_tpu_torch.embeddings",
            "lantern_tpu_torch.weighted",
            "lantern_tpu_torch.autotune",
            "lantern_tpu_torch.service.protocol",
            "lantern_tpu_torch.service.client",
            "lantern_tpu_torch.service.index_server",
            "lantern_tpu_torch.service.http_api",
            "lantern_tpu_torch.service.daemon",
            "lantern_tpu_torch.service.bgworkers",
            "lantern_tpu_torch.cli",
            "lantern_tpu_torch.parallel",
            "lantern_tpu_torch.parallel.sharded",
            "lantern_tpu_torch.parallel._dist",
            "lantern_tpu_torch.models",
            "lantern_tpu_torch.text",
            "lantern_tpu_torch.text.bloom",
            "lantern_tpu_torch.text.bm25",
            "lantern_tpu_torch.text.stemmer",
            "lantern_tpu_torch.utils.bench"} <= set(mods), mods
    import torch
    from lantern_tpu_torch import HnswParams, Index
    if not torch.cuda.is_available():
        try:
            Index(HnswParams(dim=8))
        except RuntimeError as e:
            assert "CUDA" in str(e)
        else:
            raise AssertionError("Index without a device ran on the CPU")
        from lantern_tpu_torch.service.http_api import HttpApi
        from lantern_tpu_torch.service.index_server import IndexServer
        from lantern_tpu_torch.parallel import init_multihost, make_mesh
        for make in (lambda: IndexServer(port=0, status_port=None),
                     lambda: HttpApi(port=0), make_mesh,
                     lambda: init_multihost("127.0.0.1:29500", 1, 0,
                                            backend="gloo")):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("a service or a mesh without a "
                                     "device ran on the CPU")
    import os, tempfile
    from lantern_tpu_torch.parallel import init_multihost, make_mesh
    store = os.path.join(tempfile.mkdtemp(), "store")
    init_multihost(num_processes=1, process_id=0, device="cpu",
                   init_method="file://" + store)
    mesh = make_mesh(2)
    assert mesh.distributed and mesh.local_shards == (0, 1), mesh
    assert str(mesh.device) == "cpu" and mesh.shape == {"data": 1, "shard": 2}
    torch.distributed.destroy_process_group()
    print("isolated", len(mods))
""")


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
