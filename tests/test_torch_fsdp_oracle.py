"""An f64 oracle for the bound of ``test_torch_fsdp.py``'s LM case.

That case runs Adam at ``LR_LM = 1e-3`` where JAX's own test uses 1e-2:
at 1e-2 one element of 32,768 (``blocks/ffn_out/kernel[1, 232, 51]``)
ended 1.1e-4 from JAX's after three steps, past the 5e-5 + 2e-4|v|
bound. Its first f64 gradient is -2.1e-8, under Adam's eps of 1e-8, so
Adam's first update there rests on the gradient's last digits. This
test asks whether the port's f32 gradient is any worse than JAX's: along
the f64 Adam trajectory (lr 1e-2, the case's three batches), at each
step's f64 parameters rounded to f32, the port's gradient (``fused_lm_loss``)
and JAX's (its ``fused_lm_loss``, the Pallas kernels in interpret mode)
are held against JAX's gradient in f64 (x64, the reference attention and
the plain cross-entropy).

Tolerance: the port's largest error over all elements within twice
JAX's, at every step (same-order f32 rounding; a wrong term would be
orders of magnitude off), and at the element above within twice JAX's
plus 1e-9 (a few f32 ulps of the leaf's largest gradient).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models import transformer as jt
from chainermn_tpu.ops.fused_ce import fused_lm_loss as jax_fused
from chainermn_torch.models.convert import flax_params, params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.ops.fused_ce import fused_lm_loss
from tests.test_torch_fsdp import LM, _jax_lm, lm_tokens

LR, B1, B2, EPS = 1e-2, 0.9, 0.999, 1e-8
ELEMENT = ("block_1/ffn_out/kernel", (232, 51))
BLOCK_V = 256           # the vocabulary's one fused-CE tile


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = np.asarray(v, np.float64)
    return out


def _port_grad(params, toks):
    m = TransformerLM(**LM, device="cpu")
    m.load_state_dict(params_from_flax(m, params))
    x = torch.as_tensor(toks[:, :-1]).long()
    y = torch.as_tensor(toks[:, 1:]).long()
    fused_lm_loss(m, x, y, block_v=BLOCK_V)[0].backward()
    with torch.no_grad():
        for q in m.parameters():
            q.copy_(q.grad)
    return _flat(jax.tree_util.tree_map(np.asarray, flax_params(m)))


def _jax_grad(model, params, toks):
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    g = jax.grad(lambda p: jax_fused(model, p, x, y, block_v=BLOCK_V)[0])(
        params)
    return _flat(jax.tree_util.tree_map(np.asarray, g))


def test_the_ports_lm_gradient_is_as_close_to_f64_as_jaxs():
    model, params = _jax_lm()
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    m = jax.tree_util.tree_map(np.zeros_like, p)
    v = jax.tree_util.tree_map(np.zeros_like, p)
    with jax.enable_x64(True):
        m64 = model.clone(dtype=jnp.float64, attention="reference")
    rows = []
    for t, toks in enumerate(lm_tokens()):
        with jax.enable_x64(True):
            g64t = jax.grad(lambda q: jt.lm_loss_with_aux(
                m64, q, jnp.asarray(toks[:, :-1]),
                jnp.asarray(toks[:, 1:]))[0])(jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64), p))
            g64t = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), g64t)
        g64 = _flat(g64t)
        p32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
        gp, gj = _port_grad(p32, toks), _jax_grad(model, p32, toks)
        ep = max(np.abs(gp[k] - g64[k]).max() for k in g64)
        ej = max(np.abs(gj[k] - g64[k]).max() for k in g64)
        k, i = ELEMENT
        rows.append((t, g64[k][i], abs(gp[k][i] - g64[k][i]),
                     abs(gj[k][i] - g64[k][i]), ep, ej))
        # optax's Adam, in f64
        m = jax.tree_util.tree_map(lambda a, g: B1 * a + (1 - B1) * g, m,
                                   g64t)
        v = jax.tree_util.tree_map(lambda a, g: B2 * a + (1 - B2) * g * g,
                                   v, g64t)
        c1, c2 = 1 - B1 ** (t + 1), 1 - B2 ** (t + 1)
        p = jax.tree_util.tree_map(
            lambda a, mm, vv: a - LR * (mm / c1) / (np.sqrt(vv / c2) + EPS),
            p, m, v)
    for t, g, ep_i, ej_i, ep, ej in rows:
        print(f"step {t}: {ELEMENT[0]}{ELEMENT[1]} f64 gradient {g:.3e}, "
              f"error port {ep_i:.3e} JAX {ej_i:.3e}; all elements: port "
              f"{ep:.3e} JAX {ej:.3e}")
        assert ep <= 2 * ej, (t, ep, ej)
        assert ep_i <= 2 * ej_i + 1e-9, (t, ep_i, ej_i)
    assert abs(rows[0][1]) < EPS * 3      # Adam's eps decides step 0 there
