"""ptp/context.py of the port against the JAX package at one attention site.

The EditContext's value-space cross edit (refine/replace, with and without
reweight) and its self swap from stored (q, k) (gate 0 / 0.5 / 1, with and
without a blend mask, with a sparse-causal re-gather) are held against the
JAX EditContext on the same seeded tensors; so is the materialised
`process` path, and make_controller's mappers, schedules and windows
against the JAX controller (exactly: both are the same numpy code). Tolerance 2e-5: fp32 on both sides, the same contractions
in possibly another summation order, on O(1) outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fatezero_tpu.models.tokenizer import StubTokenizer
from fatezero_tpu.ptp import context as J
from fatezero_tpu.ptp.controller import make_controller as jmake_controller
from fatezero_tpu_torch.ptp import context as C
from fatezero_tpu_torch.ptp.controller import make_controller

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
B, F, H, S, KV, D = 2, 3, 2, 16, 77, 8


def _params(kind, eq, gate, mask, lib, xp):
    rng = np.random.RandomState(0)
    mapper = rng.rand(1, KV, KV).astype(np.float32)
    refine_mapper = rng.randint(0, KV, (1, KV))
    refine_alphas = rng.rand(1, KV).astype(np.float32)
    equalizer = (1 + rng.rand(1, KV)).astype(np.float32)
    masks = {S: (rng.rand(F, 1, S, 1) > 0.5).astype(np.float32)}
    return lib.EditParams(
        cross_edit_kind=kind,
        mapper=xp(mapper),
        refine_mapper=xp(refine_mapper),
        refine_alphas=xp(refine_alphas),
        equalizer=xp(equalizer) if eq else None,
        self_replace_active=False,
        self_gate=None if gate is None else xp(np.float32(gate)),
        self_masks={k: xp(v) for k, v in masks.items()} if mask else None,
        save_self_attention=False,
    )


def _jnp(a):
    return jnp.asarray(a)


def _torch(a):
    return torch.as_tensor(np.asarray(a))


def _probs(rng, shape):
    p = rng.rand(*shape).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("kind", ["refine", "replace"])
@pytest.mark.parametrize("eq", [False, True])
@pytest.mark.parametrize("path", ["value_space", "process"])
def test_cross_edit_matches_jax(kind, eq, path):
    rng = np.random.RandomState(1)
    q = rng.randn(B, F, H, S, D).astype(np.float32)
    k = rng.randn(B, 1, H, KV, D).astype(np.float32)
    v = rng.randn(B, 1, H, KV, D).astype(np.float32)
    base = _probs(rng, (1, F, H, S, KV))
    aw = rng.rand(1, 1, KV).astype(np.float32)
    live = _probs(rng, (B, F, H, S, KV))

    def run(lib, xp):
        # the port's EditContext always runs cross sites in value space; the
        # JAX one does when asked to (its pipeline's stored edit asks)
        extra = {"value_space_cross": True} if lib is J else {}
        ctx = lib.EditContext(
            {"down_cross": [xp(base)]}, _params(kind, eq, None, False, lib, xp), xp(aw),
            store_dtype=jnp.float32 if lib is J else torch.float32, **extra,
        )
        if path == "value_space":
            return ctx.value_space_attention(xp(q), xp(k), xp(v), D**-0.5, "down", True, (B, F))
        return ctx.process(xp(live), "down", True)

    np.testing.assert_allclose(run(C, _torch).numpy(), np.asarray(run(J, _jnp)), **TOL)


@pytest.mark.parametrize("gate", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_self_swap_matches_jax(gate, mask, sparse):
    rng = np.random.RandomState(2)
    spec = ("mid",) if sparse else None
    q = rng.randn(B, F, H, S, D).astype(np.float32)
    k = rng.randn(B, F, H, S, D).astype(np.float32)
    v = rng.randn(B, F, H, S, D).astype(np.float32)
    n_ref = 1 if sparse else F
    q_inj = rng.randn(1, F, S, H * D).astype(np.float32)
    k_inj = rng.randn(1, n_ref, S, H * D).astype(np.float32)
    site = {"sparse_meta": (spec, F, H)} if sparse else {}

    def run(lib, xp):
        ctx = lib.EditContext(
            {}, _params("refine", False, gate, mask, lib, xp), xp(np.ones((1, 1, KV), np.float32)),
            store_dtype=jnp.float32 if lib is J else torch.float32,
            injected_qk={"up_self": [(xp(q_inj), xp(k_inj))]},
        )
        return ctx.value_space_attention(xp(q), xp(k), xp(v), D**-0.5, "up", False, (B, F), **site)

    np.testing.assert_allclose(run(C, _torch).numpy(), np.asarray(run(J, _jnp)), **TOL)


@pytest.mark.parametrize("gate", [None, 0.0, 1.0])
def test_self_process_matches_jax(gate):
    rng = np.random.RandomState(3)
    base = _probs(rng, (1, F, H, S, S))
    live = _probs(rng, (B, F, H, S, S))

    def run(lib, xp):
        params = _params("refine", False, gate, True, lib, xp)
        params.self_replace_active = gate is None
        ctx = lib.EditContext(
            {"mid_self": [xp(base)]}, params, xp(np.ones((1, 1, KV), np.float32)),
            store_dtype=jnp.float32 if lib is J else torch.float32,
        )
        return ctx.process(xp(live), "mid", False)

    np.testing.assert_allclose(run(C, _torch).numpy(), np.asarray(run(J, _jnp)), **TOL)


def test_store_context_and_heads():
    rng = np.random.RandomState(4)
    x = rng.randn(1, F, H, S, D).astype(np.float32)
    merged = C.merge_heads(_torch(x))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(J.merge_heads(_jnp(x))))
    np.testing.assert_array_equal(C.split_heads(merged, H).numpy(), x)
    probs = _probs(rng, (B, F, H, S, KV))
    tctx, jctx = C.StoreContext(store_dtype=torch.float32), J.StoreContext(store_dtype=jnp.float32)
    tctx.process(_torch(probs), "up", True)
    jctx.process(_jnp(probs), "up", True)
    np.testing.assert_array_equal(tctx.captured["up_cross"][0].numpy(), np.asarray(jctx.captured["up_cross"][0]))
    assert C.store_key("mid", False) == J.store_key("mid", False)
    noop = C.NoopContext()
    assert noop.process(_torch(probs), "up", True) is not None
    assert noop.value_space_attention(_torch(x), _torch(x), _torch(x), 1.0, "up", False, (1, F)) is None


@pytest.mark.parametrize(
    "target,replace,eq",
    [
        ("watercolor painting of a silver jeep driving", False, {"words": ["watercolor"], "values": [10]}),
        ("a posche car driving", True, {"words": ["posche"], "values": [2.0]}),
        ("a posche car driving", True, None),
    ],
    ids=["teaser-refine-reweight", "replace-reweight", "replace"],
)
def test_controller_matches_jax(target, replace, eq):
    tok = StubTokenizer()
    prompts = ["a silver jeep driving", target]
    kw = dict(num_steps=10, is_replace_controller=replace, cross_replace_steps=0.8,
              self_replace_steps=0.6, eq_params=eq)
    ours, ref = make_controller(tok, prompts, **kw), jmake_controller(tok, prompts, **kw)
    assert ours.cross_edit_kind == ref.cross_edit_kind == ("replace" if replace else "refine")
    for name in ("mapper", "refine_mapper", "refine_alphas", "equalizer", "alpha_time_words"):
        a, b = getattr(ref, name), getattr(ours, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
    assert ours.self_replace_window == ref.self_replace_window
    for n in (4, 10):
        assert ours.edit_window(n) == ref.edit_window(n)
    assert [ours.self_replace_active(i) for i in range(10)] == [ref.self_replace_active(i) for i in range(10)]
