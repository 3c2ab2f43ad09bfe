"""Eval step (counterpart of ``vlsat_tpu/train/step.py:203-221``).

The JAX step is a jitted ``model.apply(variables, batch)``; here the step
runs the model eagerly with the weights passed in as a ``state_dict``
(``torch.func.functional_call``), so the JAX package's (params,
batch_stats) pair maps onto one argument.  The train steps come with the
training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from vlsat_tpu_torch.data.wire import decode_wire
from vlsat_tpu_torch.device import resolve_device
from vlsat_tpu_torch.models.mmgnet import MMGNet
from vlsat_tpu_torch.scene import SceneBatch


def make_eval_step(model: MMGNet, branch_3d_only: bool = False, device=None
                   ) -> Callable[[Mapping[str, torch.Tensor], SceneBatch],
                                 Dict[str, torch.Tensor]]:
    """Returns ``eval_step(state, batch)``: moves a (wire-encoded) host
    batch to ``device`` (the card unless the caller passes ``device="cpu"``),
    widens it to f32 there and runs the model in eval mode under
    ``torch.inference_mode()`` with the weights of ``state`` (the model's
    ``state_dict`` keys, on ``device``).  The dual-branch forward by default,
    as in JAX; ``branch_3d_only=True`` is the serving mode.

    Full fp32: TF32 is switched off for matmuls and convolutions, as the
    JAX CPU reference computes in fp32."""
    if not isinstance(model, MMGNet):
        raise ValueError(f"make_eval_step takes an MMGNet, got {type(model).__name__}")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.eval()

    def eval_step(state: Mapping[str, torch.Tensor], batch: SceneBatch
                  ) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            batch = decode_wire(batch.to(dev, non_blocking=True))
            return torch.func.functional_call(
                model, dict(state), (batch,), {"branch_3d_only": branch_3d_only},
                strict=True)

    eval_step.device = dev  # where eval.engine.evaluate sends the batches
    return eval_step
