"""Shared set-up of the LM-stack parity tests (``tests/test_torch_{lm,
lm_cache,attention,serve,train,train_step}.py``): JAX parameters from
``repro``'s ``materialize`` carried to the port through
``convert.lm_params``, and batches made with numpy from a seed and handed
to both packages."""
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
from repro_torch.models.common import leaves, tmap
from repro_torch.models.lm import LM as TLM
from repro_torch.train import step as tstep

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


#: training against JAX: a leaf's gradient within GRAD_TOL of its largest
#: entry (this init's attention scores reach the hundreds, and the
#: softmax amplifies last-bit differences of XLA's and torch's matmuls:
#: 1.1e-3 seen, on llama4; most configs 1e-4 or less); the loss and its
#: metrics within LOSS_RTOL (float32 sums in another order)
GRAD_TOL = 3e-3
LOSS_RTOL = 2e-6


def train_batch(cfg, b: int = 2, s: int = 16):
    """:func:`batch` with labels, the tokens rolled by one."""
    jb, tb = batch(cfg, b, s)
    labels = np.roll(np.asarray(jb["tokens"]), -1, axis=1)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels).long()
    return jb, tb


def port_grads(model, params, batch, remat: bool = True, rule=None):
    """The port's loss, metrics and every leaf's gradient (zeros where
    the loss does not reach), in ``leaves`` order."""
    live = tmap(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = tstep.loss_fn(model, live, batch, rule=rule,
                                  remat=remat)
    loss.backward()
    return loss.detach(), metrics, [
        t.grad if t.grad is not None else torch.zeros_like(t)
        for t in leaves(live)]


def leaf_close(want, got, tol: float) -> None:
    """``got`` within ``tol`` of ``want``'s largest entry."""
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()) + 1e-12)
