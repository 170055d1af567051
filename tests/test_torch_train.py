"""The port's training functions against the reference on the CPU.

``loss_fn``/``train_step_fn`` (``models/llama.py``) and ``moe_loss_fn``/
``moe_train_step_fn`` (``models/moe.py``) at TINY/TINY_MOE in float32 with
the reference's weights carried across by ``params_from_jax``, on tokens
drawn with numpy.  Losses are held to 1e-5 relative and one SGD step's
updated params to 1e-5 absolute: the same float32 arithmetic in another
order.  Also the routing the training forward depends on: the kernels have
no backward, so each kernel wrapper (and each tensor-parallel composition)
refuses a call that autograd would record, and ``use_kernels=False`` takes
the plain attention on every device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models import llama as jl
from infinistore_tpu.models import moe as jmoe
from infinistore_tpu_torch.models import attention as tattn
from infinistore_tpu_torch.models import params_from_jax
from infinistore_tpu_torch.models.llama import (
    TINY,
    leaves,
    loss_fn,
    prefill_forward,
    scaled,
    train_step_fn,
    trainable,
)
from infinistore_tpu_torch.models.moe import (
    TINY_MOE,
    moe_loss_fn,
    moe_prefill_forward,
    moe_train_step_fn,
    scaled_moe,
)
from infinistore_tpu_torch.ops import cuda_attention as ca

torch.set_num_threads(2)

LOSS_RTOL = 1e-5   # float32 loss, another summation order
PARAM_ATOL = 1e-5  # float32 params after one SGD step

# name -> knobs on TINY (both packages take the same names)
CONFIGS = {
    "llama": {},
    # windowed attention and both soft-caps (Gemma-2's knobs)
    "window_softcap": dict(sliding_window=6, window_pattern=2,
                           attn_softcap=20.0, final_softcap=15.0,
                           norm_offset=True, post_norms=True,
                           embed_scale=True, act="gelu_tanh"),
    # QKV biases and per-head Q/K norms (Qwen2, Qwen3)
    "bias_qknorm": dict(attn_bias=True, qk_norm=True),
}


def _cfgs(name):
    kw = CONFIGS[name]
    return (jl.scaled(jl.TINY, dtype=jnp.float32, **kw),
            scaled(TINY, dtype=torch.float32, **kw))


def _carried(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _tokens(seed, shape=(2, 16), vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, size=shape).astype(
        np.int32)


def _max_leaf_err(jparams, tparams, tcfg) -> float:
    want = leaves(_carried(jparams, tcfg))
    got = leaves(tparams)
    assert len(want) == len(got)
    return max(float((a - b).abs().max()) for a, b in zip(want, got))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_fn_matches_reference(name):
    cfg, tcfg = _cfgs(name)
    jp = jl.init_params(cfg, jax.random.PRNGKey(0))
    tok = _tokens(1)
    want = float(jl.loss_fn(jp, cfg, jnp.asarray(tok)))
    got = loss_fn(_carried(jp, tcfg), tcfg, torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= LOSS_RTOL * abs(want), (float(got), want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_reference(name):
    """One SGD step: the loss and every updated leaf against the
    reference's step on the same params and tokens."""
    cfg, tcfg = _cfgs(name)
    jp = jl.init_params(cfg, jax.random.PRNGKey(0))
    tok = _tokens(2, (3, 12))
    jnew, jloss = jax.jit(jl.train_step_fn(cfg, lr=5e-2))(jp, jnp.asarray(tok))
    tnew, tloss = train_step_fn(tcfg, lr=5e-2)(_carried(jp, tcfg),
                                               torch.from_numpy(tok))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert _max_leaf_err(jnew, tnew, tcfg) <= PARAM_ATOL


def test_train_step_reduces_loss():
    """The port of ``tests/test_models.py::test_train_step_reduces_loss``."""
    tcfg = scaled(TINY, dtype=torch.float32)
    params = _carried(jl.init_params(jl.scaled(jl.TINY, dtype=jnp.float32),
                                     jax.random.PRNGKey(0)), tcfg)
    tokens = torch.from_numpy(_tokens(4, (4, 16)))
    step = train_step_fn(tcfg, lr=1e-2)
    loss0 = float(loss_fn(params, tcfg, tokens))
    for _ in range(5):
        params, loss = step(params, tokens)
    assert float(loss) < loss0


def test_every_leaf_gets_a_gradient_and_moves_in_place():
    """Every leaf has a finite, nonzero gradient; the step updates the
    caller's tensors in place (same objects, no grad flag left on them)
    and returns a detached loss."""
    tcfg = scaled(TINY, dtype=torch.float32, attn_bias=True, qk_norm=True)
    params = _carried(jl.init_params(
        jl.scaled(jl.TINY, dtype=jnp.float32, attn_bias=True, qk_norm=True),
        jax.random.PRNGKey(3)), tcfg)
    ps = leaves(params)
    before = [p.clone() for p in ps]
    tokens = torch.from_numpy(_tokens(5))
    tree, pairs = trainable(params)
    grads = torch.autograd.grad(loss_fn(tree, tcfg, tokens),
                                [a for _, a in pairs])
    names = [f"{k}.{kk}[{i}]" if isinstance(v, dict) else k
             for k, v in params.items()
             for kk in (v if isinstance(v, dict) else [None])
             for i in (range(len(v[kk])) if isinstance(v, dict) else [0])]
    assert len(names) == len(grads) == 3 + 14 * tcfg.n_layers
    for name, (p, a), g in zip(names, pairs, grads):
        assert g is not None and g.shape == p.shape, name
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
    # the layer aliases are views of the stacked tensors
    wq = params["layers"]["wq"]
    wq_aliases = [a for n, (_, a) in zip(names, pairs)
                  if n.startswith("layers.wq[")]
    assert len(wq_aliases) == tcfg.n_layers
    assert all(a.untyped_storage().data_ptr() == wq.untyped_storage()
               .data_ptr() for a in wq_aliases)
    out, loss = train_step_fn(tcfg, lr=1e-2)(params, tokens)
    assert out is params and not loss.requires_grad
    for p, p0, q in zip(ps, before, leaves(out)):
        assert q is p and not p.requires_grad
        assert not torch.equal(p, p0)


def test_train_step_in_bf16_keeps_the_dtype():
    """bf16 params stay bf16 (``p - lr * g.to(p.dtype)``) and the loss is
    float32, as the reference's."""
    tcfg = scaled(TINY, dtype=torch.bfloat16)
    params = _carried(jl.init_params(jl.scaled(jl.TINY, dtype=jnp.bfloat16),
                                     jax.random.PRNGKey(0)), tcfg)
    params, loss = train_step_fn(tcfg, lr=1e-1)(
        params, torch.from_numpy(_tokens(6)))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.bfloat16 for p in leaves(params))


# ---- MoE ----

MCFG = jmoe.scaled_moe(jmoe.TINY_MOE, dtype=jnp.float32)
TMCFG = scaled_moe(TINY_MOE, dtype=torch.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_loss_fn_matches_reference(seed):
    jp = jmoe.init_moe_params(MCFG, jax.random.PRNGKey(seed))
    tok = _tokens(10 + seed)
    want = float(jmoe.moe_loss_fn(jp, MCFG, jnp.asarray(tok)))
    got = float(moe_loss_fn(_carried(jp, TMCFG), TMCFG, torch.from_numpy(tok)))
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_moe_train_step_matches_reference():
    """One SGD step, the float32 router included."""
    jp = jmoe.init_moe_params(MCFG, jax.random.PRNGKey(0))
    tok = _tokens(12)
    jnew, jloss = jax.jit(jmoe.moe_train_step_fn(MCFG, lr=5e-2))(
        jp, jnp.asarray(tok))
    tnew, tloss = moe_train_step_fn(TMCFG, lr=5e-2)(_carried(jp, TMCFG),
                                                    torch.from_numpy(tok))
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert _max_leaf_err(jnew, tnew, TMCFG) <= PARAM_ATOL
    assert tnew["layers"]["router"].dtype == torch.float32


def test_moe_forward_shapes_and_grad():
    """The port of ``tests/test_moe.py::test_moe_forward_shapes_and_grad``,
    both halves: the forward's shapes, then the loss falling over five
    steps."""
    params = _carried(jmoe.init_moe_params(MCFG, jax.random.PRNGKey(0)), TMCFG)
    tokens = torch.from_numpy(_tokens(13, (2, 16)))
    with torch.no_grad():
        logits, kv = moe_prefill_forward(params, TMCFG, tokens)
    assert logits.shape == (2, 16, TMCFG.vocab_size)
    assert kv.shape == (TMCFG.n_layers, 2, 2, 16, TMCFG.n_kv_heads,
                        TMCFG.head_dim)
    step = moe_train_step_fn(TMCFG, lr=1e-2)
    p, loss0 = step(params, tokens)
    for _ in range(5):
        p, loss = step(p, tokens)
    assert float(loss) < float(loss0)


# ---- the kernels refuse autograd; use_kernels=False routes around them ----

B, S, H, HKV, D, NB, T = 2, 8, 4, 2, 32, 6, 4


def _kernel_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v = r(B, S, H, D), r(B, S, HKV, D), r(B, S, HKV, D)
    kp, vp = r(B, 3 + S, HKV, D), r(B, 3 + S, HKV, D)
    q1, cache = r(B, H, D), r(2, HKV, NB, T, D)
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lens = torch.tensor([9, 5], dtype=torch.int32)
    return {
        "K1": (ca.paged_decode_attention_cuda,
               (q1, cache, table, lens), {}),
        "K2": (ca.flash_prefix_attention_cuda, (q, kp, vp, 3, 2), {}),
        "K3": (ca.flash_causal_attention_cuda, (q, k, v), {}),
        "K4": (ca.paged_decode_attention_alllayers_cuda,
               (q1[None], cache[None], table, lens), {}),
        "flash_causal_attention_tp": (
            tattn.flash_causal_attention_tp, (q, k, v, 2),
            dict(n_heads=2 * H, n_kv_heads=2 * HKV)),
        "paged_decode_attention_tp": (
            tattn.paged_decode_attention_tp, (q1, cache, table, lens, 2),
            dict(n_heads=2 * H, n_kv_heads=2 * HKV)),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4",
                                  "flash_causal_attention_tp",
                                  "paged_decode_attention_tp"])
def test_kernel_wrappers_refuse_autograd(name):
    """A kernel has no backward: called with grad mode on and an input
    that requires grad, its wrapper raises (on the CPU too, where its
    plain version stands in); under ``no_grad``, or with no input
    requiring grad, the same call runs."""
    fn, args, kw = _kernel_calls()[name]
    want = fn(*args, **kw)
    with torch.no_grad():
        assert torch.equal(fn(*args, **kw), want)
    grad_args = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*grad_args, **kw)
    with torch.no_grad():
        assert torch.equal(fn(*grad_args, **kw), want)


@pytest.mark.parametrize("prefix", [False, True])
def test_use_kernels_false_takes_the_plain_attention_off_the_cpu(prefix):
    """On a device other than the CPU (``meta`` stands in for the card
    here), ``causal_attention`` sends the call to a kernel wrapper, which
    refuses a non-CUDA tensor; ``use_kernels=False`` takes the plain
    version there, as the training forward does."""
    q = torch.empty(B, S, H, D, device="meta")
    k = torch.empty(B, 3 + S if prefix else S, HKV, D, device="meta")
    kw = dict(q_offset=3, prefix_pad=3, prefix_len=2) if prefix else {}
    with pytest.raises(ValueError, match="K2 runs on CUDA" if prefix
                       else "K3 runs on CUDA"):
        tattn.causal_attention(q, k, k, **kw)
    out = tattn.causal_attention(q, k, k, use_kernels=False, **kw)
    assert out.shape == (B, S, H, D) and out.device.type == "meta"


@pytest.mark.parametrize("forward,cfg", [(prefill_forward, TINY),
                                         (moe_prefill_forward, TINY_MOE)])
def test_forward_use_kernels_false_reaches_no_kernel(forward, cfg):
    """The whole forward with ``use_kernels=False`` on a ``meta`` model
    runs to its logits without touching a kernel wrapper; with the
    kernels it reaches one."""
    cfg = (scaled if forward is prefill_forward else scaled_moe)(
        cfg, dtype=torch.float32)
    params = _meta_params(cfg, moe=forward is moe_prefill_forward)
    tokens = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    logits, kv = forward(params, cfg, tokens, use_kernels=False)
    assert logits.shape == (2, 8, cfg.vocab_size)
    with pytest.raises(ValueError, match="K3 runs on CUDA"):
        forward(params, cfg, tokens)


def _meta_params(cfg, moe: bool):
    from infinistore_tpu_torch.models import init_moe_params, init_params

    if moe:
        p = init_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    else:
        p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return {k: ({kk: vv.to("meta") for kk, vv in v.items()}
                if isinstance(v, dict) else v.to("meta"))
            for k, v in p.items()}
