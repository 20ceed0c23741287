"""The served pair of this configuration: its JSON file beside this one
holds the sizes; the weights, the coupled target's slot-pool protocol and
the reference's shapes come from `harness/coupled.py`; the plain reference
is `reference/model.py`."""
from perfbench.harness import coupled


def build(spec: dict, seed: int, device, rows_per_slot: int):
    return coupled.build(spec, seed, device, rows_per_slot)
