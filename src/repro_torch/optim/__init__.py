"""Optimizers: AdamW with fp32 or 8-bit quantized moments."""

from repro_torch.optim.adamw import (OptConfig, Q8State, adamw_init, adamw_update,
                                     opt_state_specs)

__all__ = ["OptConfig", "Q8State", "adamw_init", "adamw_update", "opt_state_specs"]
