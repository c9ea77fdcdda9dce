"""Encoder-decoder (whisper-style): a bidirectional encoder over stub frame
embeddings, and the decoder of ``C`` blocks that cross-attends to its
states.

Counterpart of :mod:`repro.models.encdec`.  As in the reference, the audio
frontend (mel spectrogram and convolutional downsampling) is a stub: the
frames come in as embeddings (B, encoder_seq, d_model), and this module is
the transformer backbone that consumes them.  The encoder's layers are a
list, keyed as the reference keys them (``encoder/layers/<i>/...``); the
decoder is :mod:`repro_torch.models.transformer`'s LM with ``encoder_out``.
Its attention is the flash kernels on CUDA (``causal=False`` in the
encoder, ``Sq != Skv`` in the decoder's cross-attention), the plain
oracle on the CPU.  ``param_hook`` (:data:`repro_torch.models.transformer.
ParamHook`) is applied to each encoder layer when it runs, with its path
``("encoder", "layers", i)``, and to the decoder's leaves under
``("decoder", ...)``.  ``tp`` (tensor parallelism, :mod:`repro_torch.comm.
tensor_parallel`) splits the encoder's attention heads and MLP as it does
the decoder's blocks; the encoder's states are whole on every ``model``
rank.
"""
from __future__ import annotations

import torch

from repro_torch.comm.tensor_parallel import TensorParallel
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, Params, apply_norm, init_norm


def init_encoder(cfg: ModelConfig, gen: torch.Generator | None, device) -> Params:
    """``cfg.encoder_layers`` pre-norm layers (bidirectional attention +
    dense MLP) and a final norm."""
    layers = [{"norm1": init_norm(cfg, device),
               "attn": attn.init_attention(cfg, gen, device),
               "norm2": init_norm(cfg, device),
               "mlp": B.init_mlp(cfg, gen, device)}
              for _ in range(cfg.encoder_layers)]
    return {"layers": layers, "final_norm": init_norm(cfg, device)}


def _no_hook(p, path, unit=None):
    return p


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           param_hook: T.ParamHook | None = None,
           tp: TensorParallel | None = None) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder states (B, S_enc, d).
    Each layer's attention is bidirectional, with RoPE at ``arange(S_enc)``
    as in the reference.  ``params`` is the tree's ``encoder``."""
    ph = param_hook or _no_hook
    x = frames
    for i, layer in enumerate(params["layers"]):
        lp = ph(layer, ("encoder", "layers", i), None)
        h = apply_norm(cfg, lp["norm1"], x)
        x = x + attn.attention_fwd(cfg, lp["attn"], h, causal=False, tp=tp)
        h = apply_norm(cfg, lp["norm2"], x)
        x = x + B.mlp_apply(cfg, lp["mlp"], h, tp)
    return apply_norm(cfg, ph(params["final_norm"], ("encoder", "final_norm"), None), x)


def _decoder_hook(param_hook: T.ParamHook | None) -> T.ParamHook | None:
    """``param_hook`` on the decoder's paths, under ``("decoder",)``."""
    if param_hook is None:
        return None
    return lambda p, path, unit=None: param_hook(p, ("decoder",) + path, unit)


def init_encdec(cfg: ModelConfig, seed: int = 0, device="cpu") -> Params:
    """``{"encoder", "decoder"}`` from ``seed`` (the decoder's generator
    from ``seed + 1``).  The layout equals ``repro.models.encdec.
    init_encdec``'s; the values do not (``transformer.from_reference``
    carries the reference's over)."""
    return {"encoder": init_encoder(cfg, T.make_generator(seed, device), device),
            "decoder": T.init_lm(cfg, seed=seed + 1, device=device)}


def forward(cfg: ModelConfig, params: Params, frames: torch.Tensor, tokens: torch.Tensor, *,
            remat: bool = False, param_hook: T.ParamHook | None = None,
            tp: TensorParallel | None = None) -> torch.Tensor:
    """(frames, decoder tokens) -> logits (B, S, V)."""
    enc = encode(cfg, params["encoder"], frames, param_hook=param_hook, tp=tp)
    return T.forward(cfg, params["decoder"], tokens, encoder_out=enc, remat=remat,
                     param_hook=_decoder_hook(param_hook), tp=tp)


def loss_fn(cfg: ModelConfig, params: Params, frames: torch.Tensor, tokens: torch.Tensor,
            labels: torch.Tensor, *, remat: bool = False,
            param_hook: T.ParamHook | None = None,
            tp: TensorParallel | None = None) -> tuple[torch.Tensor, dict]:
    enc = encode(cfg, params["encoder"], frames, param_hook=param_hook, tp=tp)
    return T.loss_fn(cfg, params["decoder"], tokens, labels, encoder_out=enc, remat=remat,
                     param_hook=_decoder_hook(param_hook), tp=tp)


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                encoder_states: torch.Tensor, token: torch.Tensor,
                pos: int, *, param_hook: T.ParamHook | None = None, seq_axis=None,
                tp: TensorParallel | None = None) -> tuple[torch.Tensor, Params]:
    """Serve step: the encoder states are computed once, when the request
    is admitted (:func:`encode`), and passed to every decode step."""
    return T.decode_step(cfg, params["decoder"], cache, token, pos,
                         encoder_out=encoder_states, seq_axis=seq_axis,
                         param_hook=_decoder_hook(param_hook), tp=tp)
