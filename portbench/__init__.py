"""portbench: the benchmark of lantern_tpu_torch, the PyTorch / CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells; ``spec.py``
says which file of this folder holds what.
"""
