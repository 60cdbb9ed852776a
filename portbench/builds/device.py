"""The port's device bulk build: ``Index(...).add(rows, build="device")``,
Lantern's CREATE INDEX with ``external=true``; levels from the run's seed."""

from portbench import system


def build(cfg: dict, rows, seed: int, device):
    return system.index(cfg, rows, seed, device, build="device")
