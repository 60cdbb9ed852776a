"""The port's local embedding runtimes (``embeddings/``) on their device,
against lantern_tpu's, on the CPU.

- ``LocalTransformerRuntime(device="cpu")`` over a tiny offline BERT (as in
  ``tests/test_ecosystem.py``) gives the reference's vectors byte for byte
  in every pooling; ``LocalVisionRuntime(device="cpu")`` with an injected
  module and processor does too, with and without a pooler output.
- With no card and no device named, both raise instead of running on the
  host, and so does ``text_embedding`` of a local model.
- A daemon's ``local`` embedding job runs on the daemon's device unless its
  ``runtime_args`` name one; HTTP text search embeds on the service's
  device. With CUDA reported absent, a job or request that did not pass
  the device on would fail.
"""

import json
import types
import urllib.request

import numpy as np
import pytest
import torch

from lantern_tpu_torch import embeddings
from lantern_tpu_torch.service.daemon import Daemon, JobQueue
from lantern_tpu_torch.service.http_api import HttpApi

CPU = "cpu"
TEXTS = ["hello world", "a doc", "hello docs world"]


@pytest.fixture()
def bert(tmp_path):
    """A tiny BERT and its tokenizer, built offline from a seed."""
    transformers = pytest.importorskip("transformers")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "hello", "world", "doc", "##s", "a"]))
    tok = transformers.BertTokenizerFast(vocab_file=str(vocab))
    cfg = transformers.BertConfig(
        vocab_size=tok.vocab_size, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=64)
    torch.manual_seed(0)
    return transformers.BertModel(cfg), tok


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture()
def local_model(monkeypatch, bert):
    """Local model paths load the tiny BERT (no weights on disk)."""
    monkeypatch.setattr(embeddings, "_load_pretrained", lambda path: bert)
    return bert


@pytest.mark.parametrize("pooling", embeddings.LocalTransformerRuntime.POOLINGS)
def test_local_transformer_byte_equal_to_reference(bert, pooling):
    from lantern_tpu.embeddings import LocalTransformerRuntime as Ref

    model, tok = bert
    kw = dict(model=model, tokenizer=tok, pooling=pooling, batch_size=2,
              max_length=16)
    got = embeddings.LocalTransformerRuntime(device=CPU, **kw)
    want = Ref(**kw).process(TEXTS)
    assert got.device == torch.device(CPU)
    out = got.process(TEXTS)
    assert out.shape == (3, 16) and out.dtype == want.dtype
    assert out.tobytes() == want.tobytes()
    dyn = embeddings.LocalTransformerRuntime(device=CPU, model=model,
                                             tokenizer=tok, batch_size=0,
                                             max_length=16)
    assert 1 <= dyn.batch_size <= 512


class TinyVision(torch.nn.Module):
    """A CLIP-shaped vision model: [B, 3, 4, 4] pixels -> a [B, 2, 8]
    hidden state and, with ``pooler``, a [B, 8] pooled output."""

    def __init__(self, pooler: bool):
        super().__init__()
        torch.manual_seed(1)
        self.proj = torch.nn.Linear(48, 8)
        self.pooler = pooler

    def forward(self, pixel_values):
        h = self.proj(pixel_values.flatten(1))
        return types.SimpleNamespace(
            last_hidden_state=torch.stack([h, 2 * h], 1),
            pooler_output=torch.tanh(h) if self.pooler else None)


def processor(images, return_tensors):
    assert return_tensors == "pt"
    px = np.stack([np.asarray(im, np.float32) / 255 for im in images])
    return {"pixel_values": torch.from_numpy(px).permute(0, 3, 1, 2)}


@pytest.mark.parametrize("pooler", [True, False])
def test_local_vision_equal_to_reference(pooler):
    from lantern_tpu.embeddings import LocalVisionRuntime as Ref

    images = list(np.random.default_rng(3).integers(
        0, 256, (5, 4, 4, 3), dtype=np.uint8))
    model = TinyVision(pooler)
    got = embeddings.LocalVisionRuntime(model=model, processor=processor,
                                        batch_size=2, device=CPU)
    want = Ref(model=model, processor=processor, batch_size=2).process(images)
    out = got.process(images)
    assert out.shape == (5, 8)
    assert out.tobytes() == want.tobytes()


def test_runtimes_without_a_card_raise(bert, no_card):
    model, tok = bert
    for make in (
            lambda: embeddings.LocalTransformerRuntime(model=model,
                                                       tokenizer=tok),
            lambda: embeddings.LocalVisionRuntime(model=TinyVision(True),
                                                  processor=processor),
            lambda: embeddings.text_embedding("BAAI/bge-small-en", "hello"),
            lambda: embeddings.get_runtime("local", model=model,
                                           tokenizer=tok)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the runtimes that do no device work still run
    assert embeddings.text_embedding("hash", "hello").shape == (128,)


def _embedding_job(tmp_path, q, runtime_args):
    inp = tmp_path / "texts.txt"
    inp.write_text("\n".join(TEXTS) + "\n")
    out = tmp_path / f"e_{len(q.list())}.npy"
    return q.submit("embedding", {"input": str(inp), "output": str(out),
                                  "runtime": "local",
                                  "runtime_args": runtime_args}), out


def test_daemon_local_job_runs_on_the_daemon_device(tmp_path, local_model,
                                                    no_card):
    model, tok = local_model
    q = JobQueue(str(tmp_path / "jobs"))
    args = {"model_path": "tiny-bert", "pooling": "cls", "batch_size": 2,
            "max_length": 16}
    passed, out = _embedding_job(tmp_path, q, args)
    named, _ = _embedding_job(tmp_path, q, {**args, "device": "cuda"})
    Daemon(q, backoff_base_s=0.01, device=CPU).run_pending()
    assert q.get(passed)["status"] == "completed", q.get(passed)
    want = embeddings.LocalTransformerRuntime(
        model=model, tokenizer=tok, device=CPU, pooling="cls", batch_size=2,
        max_length=16).process(TEXTS)
    assert np.load(out).tobytes() == want.tobytes()
    # a device named in runtime_args is the one used: here, no card
    assert q.get(named)["status"] == "failed"
    assert "CUDA" in q.get(named)["error"]


def test_http_text_search_embeds_on_the_service_device(local_model, no_card):
    api = HttpApi(port=0, device=CPU).start()
    try:
        base = f"http://127.0.0.1:{api.port}/collections"

        def post(path, body):
            req = urllib.request.Request(base + path,
                                         data=json.dumps(body).encode(),
                                         method="POST")
            req.add_header("Content-Type", "application/json")
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        rows = embeddings.LocalTransformerRuntime(
            model=local_model[0], tokenizer=local_model[1],
            device=CPU).process(TEXTS)
        post("", {"name": "docs", "metric": "l2sq"})
        post("/docs/rows", {"rows": [{"vector": r.tolist(), "text": t}
                                     for r, t in zip(rows, TEXTS)]})
        res = post("/docs/search", {"text": TEXTS[2], "model": "tiny-bert",
                                    "k": 1})
        assert res["results"][0]["text"] == TEXTS[2]
    finally:
        api.stop()
