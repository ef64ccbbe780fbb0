"""Mesh construction helpers.

The reference's comm backend is NCCL process groups
(flash_attn/utils/distributed.py) + apex parallel_state; here one
jax.sharding.Mesh spans all devices with named axes:

  data    — batch
  model   — tensor parallel (heads / mlp / vocab)
  seq     — context/ring parallel (long context)

XLA lowers the collectives to NCCL. The cards of one host are joined all
to all, so the mesh is a plain reshape of the device list in order.
"""

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def make_mesh(
    data: int = 1,
    model: int = 1,
    seq: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = data * model * seq
    assert n <= len(devices), (n, len(devices))
    arr = np.array(devices[:n]).reshape((data, model, seq))
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS, SEQ_AXIS))
