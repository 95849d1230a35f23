"""Shared set-up of the LM-stack parity tests (``tests/test_torch_{lm,
lm_cache,attention,serve}.py``): JAX parameters from ``repro``'s
``materialize`` carried to the port through ``convert.lm_params``, and
batches made with numpy from a seed and handed to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models.common import materialize as jmaterialize
from repro.models.lm import LM as JLM

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models.lm import LM as TLM

#: float32 logits: XLA's and torch's CPU matmuls accumulate in different
#: orders, and this init's attention scores reach the hundreds (``wq``'s
#: fan-in is its heads axis), so the softmax amplifies those last-bit
#: differences: the worst reduced config (llama4) differs by 1.4e-3 on
#: logits of magnitude 4-5 (3e-4 of the largest), most by about 1e-4,
#: with the flash path on or off
F32_TOL = 2e-3


@dataclasses.dataclass
class Pair:
    """One reduced config in both packages, with JAX's parameters and the
    port's copy of them."""
    arch: str
    jcfg: object
    tcfg: object
    jmodel: object
    tmodel: object
    jparams: object
    tparams: object


def configs(arch: str, act_dtype: str | None = None):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    if act_dtype:
        jcfg = dataclasses.replace(jcfg, act_dtype=act_dtype)
        tcfg = dataclasses.replace(tcfg, act_dtype=act_dtype)
    return jcfg, tcfg


def pair(arch: str, param_dtype: str = "float32",
         act_dtype: str | None = "float32", seed: int = 0,
         **overrides) -> Pair:
    """JAX parameters drawn in ``param_dtype`` (``materialize``'s default
    type), the configs at ``act_dtype`` (None: the config's own)."""
    jcfg, tcfg = configs(arch, act_dtype)
    if overrides:
        jcfg = dataclasses.replace(jcfg, **overrides)
        tcfg = dataclasses.replace(tcfg, **overrides)
    jm = JLM(jcfg)
    jp = jmaterialize(jm.param_recs(), jax.random.PRNGKey(seed),
                      default_dtype=jnp.dtype(param_dtype))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return Pair(arch, jcfg, tcfg, jm, TLM(tcfg), jp, tp)


def batch(cfg, b: int, s: int, seed: int = 1):
    """numpy tokens (and patch embeddings, frames) from a seed, as a JAX
    batch and a torch batch holding the same values."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_img_tokens:
        arrays["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        arrays["frames"] = rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v).long() if k == "tokens"
          else torch.from_numpy(v) for k, v in arrays.items()}
    return jb, tb


def np32(x) -> np.ndarray:
    """JAX array or tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def max_err(a, b) -> float:
    return float(np.abs(np32(a) - np32(b)).max())
