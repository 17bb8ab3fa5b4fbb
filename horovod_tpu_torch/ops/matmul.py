"""Matrix products whose result stays in float32.

Where the JAX package asks ``dot_general`` for
``preferred_element_type=float32`` on bf16 operands (the cross-entropy
logits and its dh/dw, the dw of ``flash_qkv_proj``), the product must not
be rounded to bf16: a bf16 ``torch.matmul`` would put an error of ~1e-2
into the loss.
"""

from __future__ import annotations

import torch

_LOW = (torch.bfloat16, torch.float16)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D operands of one dtype, returned in float32 and
    accumulated in float32.  On the card, bf16/fp16 operands go to the
    tensor cores with an f32 output (``aten::mm.dtype``); on the CPU, which
    has no such kernel, they are upcast first."""
    if a.is_cuda and a.dtype in _LOW:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())
