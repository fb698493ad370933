"""Driver contract: the flagship model's forward, ready to run.

Port of ``entry`` in the repository's ``__graft_entry__.py``: a
Llama-family decoder (vocab 2048, d_model 256, 4 layers, 8/4 heads,
head_dim 32, d_ff 1024) with weights from seed 0, and a [2, 128] batch of
token ids. The JAX ``entry`` returns a jittable function of (params,
tokens); here the function takes (model, tokens) and runs eagerly, through
the flash kernels on the card. ``dryrun.py`` is the twin of
``dryrun_multichip``.

    fn, args = entry()
    logits = fn(*args)  # [2, 128, 2048] f32
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from mpi_operator_tpu_torch.models import llama
from mpi_operator_tpu_torch.runtime.bootstrap import resolve_device


def config() -> llama.Config:
    return llama.Config(vocab=2048, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
                        head_dim=32, d_ff=1024)


def entry(device: Union[str, torch.device, None] = None) -> Tuple[Callable, tuple]:
    """(fn, example_args): the forward of the head_dim-32 Llama, on the card
    unless ``device`` names the CPU (without a card it raises)."""
    device = resolve_device(device)
    model = llama.init(config(), torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.zeros(2, 128, dtype=torch.long, device=device)

    def fwd(m, t):
        return llama.apply(m, t)

    return fwd, (model, tokens)
