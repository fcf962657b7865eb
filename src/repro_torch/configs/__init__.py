"""Architecture registry: one module per assigned arch (+ the paper's own).

``get_arch(arch_id)`` returns the :class:`ArchSpec`; ``--arch`` flags in
the launchers resolve through here.
"""

import importlib

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen1.5-32b": "qwen1_5_32b",
    "stablelm-12b": "stablelm_12b",
    "starcoder2-3b": "starcoder2_3b",
    "graphsage-reddit": "graphsage_reddit",
    "graphcast": "graphcast",
    "schnet": "schnet",
    "gatedgcn": "gatedgcn",
    "mind": "mind",
    "steiner": "steiner",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "steiner")
ALL_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.ARCH
