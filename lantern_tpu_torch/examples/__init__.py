"""The repo's four examples (``examples/*.py``) as entry points of the port.

    python -m lantern_tpu_torch.examples.quickstart
    python -m lantern_tpu_torch.examples.pq_rerank
    python -m lantern_tpu_torch.examples.filters_and_maintenance
    python -m lantern_tpu_torch.examples.sharded_mesh [--ranks 1|2|4]

Each keeps its reference's data (numpy, from the reference's seed), steps
and checks, runs on ``--device`` (default ``cuda``; without a card it
raises, and runs on the host only with ``--device cpu``) at ``--n`` rows
(default ``EXAMPLE_N``, else the reference's N), and prints as its last
line one JSON object: the results its reference prints and each kernel's
launches during the run. ``main(device=None, n=None, ...)`` returns that
object. Importing a module here does nothing else.
"""
