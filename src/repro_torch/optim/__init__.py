"""Optimizers of the port: AdamW, block-wise 8-bit AdamW, Adafactor, the
learning-rate schedule and int8 gradient compression."""
from repro_torch.optim.optimizer import (OptConfig, apply_gradients,
                                         clip_by_global_norm, global_norm,
                                         init_opt_state, opt_state_specs)
from repro_torch.optim.schedule import lr_at
