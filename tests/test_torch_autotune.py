"""Parity: the port's autotune (autotune.py) against lantern_tpu's on the
CPU.

Both packages draw the same sample and queries from the seed (numpy), and
their exact oracles return the same truth ids. With the host engine pinned
to one insert thread in both packages (monkeypatched: ``autotune`` adds on
all cores, whose graph depends on thread timing), and with the device
builder (equal to the reference's on the CPU), every variant's recall is
equal (tolerance: none). Latencies and build seconds are the host clock's
and are only checked to be positive. A stored result is reused by either
package.
"""

import numpy as np
import pytest
import torch

from lantern_tpu_torch import autotune as port_autotune
from lantern_tpu_torch.config import Metric

CPU = "cpu"
VARIANTS = ((6, 32, 64), (8, 40, 64), (16, 60, 76))


def _data(rng, n=600, dim=16):
    c = rng.standard_normal((12, dim)).astype(np.float32)
    return (c[rng.integers(0, 12, n)]
            + 0.4 * rng.standard_normal((n, dim))).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Ten-query batches: torch's CPU thread pool only adds contention
    when the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def one_thread(monkeypatch):
    """Both packages' host engines insert on one thread."""
    import lantern_tpu.native as ref_native

    import lantern_tpu_torch.native as port_native

    for mod in (ref_native, port_native):
        add = mod.NativeHnsw.add
        monkeypatch.setattr(
            mod.NativeHnsw, "add",
            lambda self, v, labels=None, nthreads=0, _add=add: _add(
                self, v, labels=labels, nthreads=1))


@pytest.mark.parametrize("metric", ["l2sq", "cos"])
def test_exact_truth_ids_equal(rng, metric):
    import jax.numpy as jnp

    from lantern_tpu.ops import exact_search as ref_exact

    from lantern_tpu_torch.ops import exact_search

    vectors = _data(rng)
    m = Metric.from_string(metric)
    sel = np.random.default_rng(0)
    queries = vectors[sel.choice(len(vectors), 10, replace=False)] + 0.0
    _, got = exact_search(torch.from_numpy(queries), torch.from_numpy(vectors),
                          k=10, metric=m)
    _, want = ref_exact(jnp.asarray(queries), jnp.asarray(vectors), k=10,
                        metric=int(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine,metric", [("native", "l2sq"),
                                           ("native", "cos"),
                                           ("device", "l2sq")])
def test_variant_recalls_equal_the_reference(rng, one_thread, engine, metric):
    from lantern_tpu import autotune as ref_autotune
    from lantern_tpu.config import Metric as RefMetric

    vectors = _data(rng)
    # one compile of the reference's timed scan a variant: few variants
    variants = VARIANTS[1:] if (engine, metric) == ("native", "l2sq") \
        else VARIANTS[1:2]
    kw = dict(k=10, target_recall=0.9, sample=500, num_queries=10,
              variants=variants, engine=engine, seed=3)
    best, res = port_autotune.autotune(
        vectors, metric=Metric.from_string(metric), device=CPU, **kw)
    rbest, rres = ref_autotune.autotune(
        vectors, metric=RefMetric.from_string(metric), **kw)
    assert [(r.m, r.ef_construction, r.ef, r.recall, r.engine) for r in res] \
        == [(r.m, r.ef_construction, r.ef, r.recall, r.engine) for r in rres]
    assert all(r.latency_s > 0 and r.build_s > 0 for r in res)
    assert (best is None) == (rbest is None)
    if best is not None:
        assert best.recall >= 0.9


def test_prior_result_reuse_across_packages(tmp_path, rng):
    """A stored result for the model short-circuits the sweep (mod.rs:
    111-159); the store is the reference's JSON, so a result one package
    stored is reused by the other."""
    from lantern_tpu import autotune as ref_autotune

    vectors = _data(rng, n=400, dim=8)
    store = str(tmp_path / "autotune.json")
    kw = dict(sample=400, target_recall=0.5, variants=VARIANTS[:2],
              model_name="my-model", results_path=store)
    best1, res1 = port_autotune.autotune(vectors, device=CPU, **kw)
    assert best1 is not None and len(res1) == 2
    best2, res2 = port_autotune.autotune(vectors, device=CPU, **kw)
    assert res2 == [best2]
    assert (best2.m, best2.ef_construction, best2.ef) == (
        best1.m, best1.ef_construction, best1.ef)
    rbest, rres = ref_autotune.autotune(vectors, **kw)
    assert len(rres) == 1 and vars(rbest) == vars(best2)
    # a different model name sweeps fresh; the reference's rows reuse here
    best3, res3 = port_autotune.autotune(
        vectors, device=CPU, **{**kw, "model_name": "other-model",
                                "variants": VARIANTS[:1]})
    assert len(res3) == 1 and best3 is not None
    ref_autotune.save_results("ref-model", rres, store)
    prior = port_autotune.load_prior_result("ref-model", store, 0.5)
    assert vars(prior) == vars(rbest)
    assert port_autotune.load_prior_result("ref-model", store, 1.01) is None
    assert port_autotune.load_prior_result("", store, 0.5) is None


def test_rows_stored_without_an_engine_load_as_unknown(tmp_path):
    import json

    store = tmp_path / "old.json"
    store.write_text(json.dumps({"m": [{
        "m": 8, "ef_construction": 40, "ef": 64, "recall": 0.95,
        "latency_s": 0.001, "build_s": 1.0}]}))
    r = port_autotune.load_prior_result("m", str(store), 0.9)
    assert r.engine == "unknown"
    assert "[unknown]" in r.exp_str()


def test_autotune_without_a_device_raises_without_a_card(monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_autotune.autotune(_data(rng, n=50, dim=8), variants=VARIANTS[:1])
