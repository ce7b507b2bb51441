"""Model API of the port: init / forward / loss_fn / prefill / decode_step
and an ``nn.Module``.

Counterpart of ``repro.models.api``: the encoder-decoder family dispatches
to :mod:`.encdec`, every other family to :mod:`.transformer`.
``prefill`` takes the reference's batch dict: ``inputs`` [B, S], plus
``img_embeds`` [B, n_img, D] for a VLM or ``enc_embeds`` [B, F, D] for an
encoder-decoder.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..weights import flatten, unflatten
from . import encdec, moe, transformer
from .spec import ModelConfig, torch_dtype
from .ssd import ssm_dims

# Leaves the JAX code reads in f32 (router, norm scales, the SSM's decay,
# skip, dt bias and gated norm): never rounded to the activation dtype, so
# cast_for_serving leaves them alone.
_F32_LEAVES = ("router", "ln1", "ln2", "ln_x", "final_norm", "enc_norm",
               "q_norm", "k_norm", "A_log", "D", "dt_bias", "norm")


def init(cfg: ModelConfig, generator: torch.Generator, device=None,
         place=None):
    """Random params in ``cfg.param_dtype``, mirroring ``ParamBuilder``:
    normal with std ``1/sqrt(fan_in)`` (``tok_embed``: std 1.0), ones for
    norm scales, zeros for biases.  ``blocks`` leaves are stacked over the
    blocks (``transformer.init_lm``), ``enc`` and ``dec`` leaves over the
    encoder and decoder layers (``encdec.init_encdec``).  The numbers
    differ from ``jax.random``'s; the shapes and scales do not.

    ``place(path, leaf) -> leaf``, where given, takes each leaf as soon as
    it is made and the tree keeps what it returns (a sharded trainer keeps
    this rank's shard), so no two whole leaves are alive at once.  The
    draws are the same with and without it."""
    transformer.check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    nb = cfg.n_blocks

    # each leaf is made when the tree is drawn (:func:`_draw`), in the
    # order of these calls
    def normal(shape, fan_in=None, std=None):
        if std is None:
            std = 1.0 / math.sqrt(max(1, fan_in))
        return lambda: torch.randn(shape, generator=generator, device=dev,
                                   dtype=dt).mul_(std)

    def ones(shape):
        return lambda: torch.ones(shape, device=dev, dtype=dt)

    def zeros(shape):
        return lambda: torch.zeros(shape, device=dev, dtype=dt)

    params = {
        "tok_embed": normal((cfg.vocab_size, D), std=1.0),
        "unembed": normal((D, cfg.vocab_size), fan_in=D),
        "final_norm": ones((D,)),
    }

    def attn(n=nb):
        p = {
            "wq": normal((n, D, H, Dh), fan_in=D),
            "wk": normal((n, D, KV, Dh), fan_in=D),
            "wv": normal((n, D, KV, Dh), fan_in=D),
            "wo": normal((n, H, Dh, D), fan_in=H * Dh),
        }
        if cfg.qkv_bias:
            p.update(bq=zeros((n, H, Dh)), bk=zeros((n, KV, Dh)),
                     bv=zeros((n, KV, Dh)))
        if cfg.qk_norm:
            p.update(q_norm=ones((n, Dh)), k_norm=ones((n, Dh)))
        return p

    def mlp(n=nb):
        F = cfg.d_ff
        return {
            "wi_gate": normal((n, D, F), fan_in=D),
            "wi_up": normal((n, D, F), fan_in=D),
            "wo": normal((n, F, D), fan_in=F),
        }

    if cfg.is_encoder_decoder:
        ne, nd = cfg.n_enc_layers, cfg.n_layers
        params["enc_norm"] = ones((D,))
        params["enc"] = {"ln1": ones((ne, D)), "attn": attn(ne),
                         "ln2": ones((ne, D)), "mlp": mlp(ne)}
        params["dec"] = {"ln1": ones((nd, D)), "attn": attn(nd),
                         "ln_x": ones((nd, D)), "xattn": attn(nd),
                         "ln2": ones((nd, D)), "mlp": mlp(nd)}
        return _draw(params, place)
    if cfg.n_img_tokens > 0:
        params["mm_proj"] = normal((D, D), fan_in=D)

    def ssm():                                   # repro.models.ssd.init_ssm
        d_inner, Hs, _, N = ssm_dims(cfg)
        K = cfg.ssm_conv
        return {
            "z_proj": normal((nb, D, d_inner), fan_in=D),
            "x_proj": normal((nb, D, d_inner), fan_in=D),
            "b_proj": normal((nb, D, N), fan_in=D),
            "c_proj": normal((nb, D, N), fan_in=D),
            "dt_proj": normal((nb, D, Hs), fan_in=D),
            "conv_x": normal((nb, K, d_inner), std=0.5),
            "conv_x_b": zeros((nb, d_inner)),
            "conv_b": normal((nb, K, N), std=0.5),
            "conv_b_b": zeros((nb, N)),
            "conv_c": normal((nb, K, N), std=0.5),
            "conv_c_b": zeros((nb, N)),
            "A_log": normal((nb, Hs), std=0.1),
            "D": zeros((nb, Hs)),
            "dt_bias": zeros((nb, Hs)),
            "norm": ones((nb, d_inner)),
            "out_proj": normal((nb, d_inner, D), fan_in=d_inner),
        }

    blocks = {}
    for pos, kind in enumerate(cfg.pattern):
        layer = {"ln1": ones((nb, D))}
        if kind == "attn":
            layer["attn"] = attn()
        else:
            layer["ssm"] = ssm()
        if transformer._has_ffn(cfg):
            layer["ln2"] = ones((nb, D))
            if transformer._layer_is_moe(cfg, pos):
                layer["moe"] = {k: normal((nb, *shape), fan_in=fan_in)
                                for k, (shape, fan_in)
                                in moe.moe_shapes(cfg).items()}
            else:
                layer["mlp"] = mlp()
        blocks[f"l{pos}"] = layer
    params["blocks"] = blocks
    return _draw(params, place)


def _draw(makers, place=None):
    """A tree of leaf makers -> the tree of their leaves, made one at a
    time in the tree's order (each through ``place``)."""
    flat = {}
    for path, make in flatten(makers).items():
        flat[path] = make() if place is None else place(path, make())
    return unflatten(flat)


def param_specs(cfg: ModelConfig):
    """The logical axes of every leaf of :func:`init`'s tree (the same
    paths), as ``repro.models.api.init`` returns them beside its params:
    a tuple of names a dim (``None``: never sharded), stacked leaves led by
    ``"layers"``.  Allocates nothing; ``parallel.sharding.param_pspecs``
    maps the tree onto a mesh."""
    transformer.check_supported(cfg)
    norm = (None,)
    attn = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        attn.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                    bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        attn.update(q_norm=norm, k_norm=norm)
    mlp = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
           "wo": ("mlp", "embed")}
    specs = {"tok_embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
             "final_norm": norm}

    def stacked(tree):
        return {k: stacked(v) if isinstance(v, dict) else ("layers", *v)
                for k, v in tree.items()}

    if cfg.is_encoder_decoder:
        specs["enc_norm"] = norm
        specs["enc"] = stacked({"ln1": norm, "attn": attn, "ln2": norm,
                                "mlp": mlp})
        specs["dec"] = stacked({"ln1": norm, "attn": attn, "ln_x": norm,
                                "xattn": attn, "ln2": norm, "mlp": mlp})
        return specs
    if cfg.n_img_tokens > 0:
        specs["mm_proj"] = ("embed", None)
    ssm = {"z_proj": ("embed", "ssm_inner"), "x_proj": ("embed", "ssm_inner"),
           "b_proj": ("embed", None), "c_proj": ("embed", None),
           "dt_proj": ("embed", None), "conv_x": (None, "ssm_inner"),
           "conv_x_b": ("ssm_inner",), "conv_b": (None, None),
           "conv_b_b": norm, "conv_c": (None, None), "conv_c_b": norm,
           "A_log": norm, "D": norm, "dt_bias": norm, "norm": ("ssm_inner",),
           "out_proj": ("ssm_inner", "embed")}
    expert = ("experts", "expert_embed", "expert_mlp")
    moe_axes = {"router": ("embed", None), "wi_gate": expert,
                "wi_up": expert,
                "wo": ("experts", "expert_mlp", "expert_embed")}
    blocks = {}
    for pos, kind in enumerate(cfg.pattern):
        layer = {"ln1": norm, ("attn" if kind == "attn" else "ssm"):
                 attn if kind == "attn" else ssm}
        if transformer._has_ffn(cfg):
            layer["ln2"] = norm
            if transformer._layer_is_moe(cfg, pos):
                layer["moe"] = moe_axes
            else:
                layer["mlp"] = mlp
        blocks[f"l{pos}"] = layer
    specs["blocks"] = stacked(blocks)
    return specs


def cast_for_serving(cfg: ModelConfig, params):
    """Round once, at load, every weight the JAX code casts to the
    activation dtype at each use; the result is the same and each step
    stops copying weights.  The leaves it reads in f32 stay as they are."""
    act = torch_dtype(cfg.dtype)
    return unflatten({
        path: (t if path.split("/")[-1] in _F32_LEAVES else t.to(act))
        for path, t in flatten(params).items()})


def loss_fn(cfg: ModelConfig, params, batch, sharded=None):
    """Training loss: batch ``inputs``, ``targets`` (+ ``mask``,
    ``img_embeds`` or ``enc_embeds``) -> (loss, metrics).  ``sharded``: a
    sharded step's ``parallel.fsdp.Sharded``, with the stacked leaves of
    ``params`` this rank's shards."""
    if cfg.is_encoder_decoder:
        return encdec.loss_fn(cfg, params, batch, sharded)
    return transformer.loss_fn(cfg, params, batch, sharded)


def forward(cfg: ModelConfig, params, batch):
    """Training forward: -> (logits over every position, aux)."""
    if cfg.is_encoder_decoder:
        return encdec.forward(cfg, params, batch["inputs"],
                              batch["enc_embeds"])
    return transformer.forward(cfg, params, batch["inputs"],
                               img_embeds=batch.get("img_embeds"))


def prefill(cfg: ModelConfig, params, batch, s_max: int, sharded=None):
    """batch ``{"inputs": [B, S]}`` (+ ``img_embeds`` or ``enc_embeds``)
    -> (last-token logits [B, V], caches)."""
    if cfg.is_encoder_decoder:
        if "enc_embeds" not in batch:
            raise ValueError(f"{cfg.name}: the batch needs enc_embeds "
                             f"[B, F, {cfg.d_model}]")
        return encdec.prefill(cfg, params, batch["inputs"],
                              batch["enc_embeds"], s_max, sharded)
    return transformer.prefill(cfg, params, batch["inputs"], s_max,
                               img_embeds=batch.get("img_embeds"),
                               sharded=sharded)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, caches,
                sharded=None):
    """token [B] -> (logits [B, V], caches advanced in place)."""
    if cfg.is_encoder_decoder:
        return encdec.decode_step(cfg, params, token, caches, sharded)
    return transformer.decode_step(cfg, params, token, caches, sharded)


class CausalLM(nn.Module):
    """A params tree held as buffers (so ``.to()`` moves it), with the
    serving entry points as methods."""

    def __init__(self, cfg: ModelConfig, params):
        super().__init__()
        transformer.check_supported(cfg)
        self.cfg = cfg
        self._names = {}
        for path, t in flatten(params).items():
            name = path.replace("/", "__")
            self._names[path] = name
            self.register_buffer(name, t)

    @classmethod
    def random(cls, cfg: ModelConfig, seed: int = 0,
               device=None) -> "CausalLM":
        """Seeded random weights, cast once for serving."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, cast_for_serving(cfg, init(cfg, gen, dev)))

    @property
    def params(self):
        return unflatten({path: getattr(self, name)
                          for path, name in self._names.items()})

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, s_max: int, *,
                img_embeds: Optional[torch.Tensor] = None,
                enc_embeds: Optional[torch.Tensor] = None):
        batch = {"inputs": tokens}
        for name, t in (("img_embeds", img_embeds),
                        ("enc_embeds", enc_embeds)):
            if t is not None:
                batch[name] = t
        return prefill(self.cfg, self.params, batch, s_max)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches):
        return decode_step(self.cfg, self.params, token, caches)
