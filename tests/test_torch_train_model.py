"""The port's train mode against the JAX reference, on the CPU, float32,
reduced configs (tolerances in ``tests/_torch_train_common.py``):
``train_loss`` and every grad leaf for half of the registered configs
(``tests/test_torch_train_families.py`` holds the other half), the chunked
cross-entropy, remat ``full`` and ``save_heavy`` (its saved set counted),
a microbatch-2 train step, the refusal of a ``DistContext`` without its
mesh's groups, and the
sharded step over a one-entry mesh, which is the one-device step bit for
bit (``tests/test_torch_train_mesh.py`` holds it against the reference's
sharded step over 2x2 and 4x2 meshes of processes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import GRAD_TOL, LOSS_RTOL, batch_for, both, check_loss_and_grads
from repro.models.layers import chunked_xent_loss as j_xent
from repro.optim import adamw as jadamw
from repro.train.train_step import build_train_step as j_build_step

from repro_torch import bridge
from repro_torch import tree as ttree
from repro_torch.models import context as tctx
from repro_torch.models.layers import chunked_xent_loss as t_xent
from repro_torch.optim import adamw as tadamw
from repro_torch.train.train_step import build_train_step, loss_and_grads


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "stablelm-1.6b", "yi-6b",
                                  "gemma2-2b", "gemma3-12b"])
def test_train_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("S,chunk,cap", [(40, 16, None), (32, 16, 30.0), (7, 16, None),
                                         (33, 8, 5.0)])
def test_chunked_xent_matches_the_reference(S, chunk, cap):
    """Value and grads of the chunked cross-entropy, positions past the
    last whole chunk left out, as in the reference."""
    rng = np.random.default_rng(S)
    emb = (0.5 * rng.standard_normal((64, 16))).astype(np.float32)
    h = rng.standard_normal((3, S, 16)).astype(np.float32)
    y = rng.integers(0, 64, (3, S)).astype(np.int32)
    jv, (jge, jgh) = jax.value_and_grad(
        lambda e, x: j_xent(e, x, jnp.asarray(y), chunk=chunk, logit_softcap=cap),
        argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(h))
    te, th = torch.from_numpy(emb).requires_grad_(), torch.from_numpy(h).requires_grad_()
    tv = t_xent(te, th, torch.from_numpy(y), chunk=chunk, logit_softcap=cap)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=LOSS_RTOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), rtol=GRAD_TOL, atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=GRAD_TOL, atol=1e-6)
    n = (S // min(chunk, S)) * min(chunk, S)
    assert not th.grad[:, n:].any()


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-7b", "deepseek-v2-236b"])
def test_remat_full_equals_no_remat(arch):
    """``remat='full'`` recomputes each pattern block in the backward: the
    loss and every grad equal the un-rematted run's bit for bit."""
    _, tc, _, tb, p = both(arch)
    _, tcr, _, tbr, _ = both(arch, remat="full")
    d = {k: torch.from_numpy(v) for k, v in batch_for(tc).items()}
    params = bridge.params_from_numpy(p, "cpu")
    l0, _, g0 = loss_and_grads(tb, params, d)
    l1, _, g1 = loss_and_grads(tbr, params, d)
    assert torch.equal(l0, l1)
    for a, b in zip(ttree.leaves(g0), ttree.leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-7b", "deepseek-v2-236b"])
def test_remat_full_matches_jax(arch):
    """``remat='full'`` on both sides: the port's checkpointed blocks
    against the reference's ``jax.checkpoint`` ones, loss and every grad
    within the tolerances of ``tests/_torch_train_common.py``."""
    check_loss_and_grads(arch, remat="full")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-236b"])
def test_remat_save_heavy_matches_jax(arch):
    """``remat='save_heavy'`` on both sides, dense and MoE: the port's
    chain of checkpointed segments against the reference's
    ``jax.checkpoint`` with ``save_only_these_names("moe_out",
    "attn_out")``, loss and every grad within the tolerances of
    ``tests/_torch_train_common.py``."""
    check_loss_and_grads(arch, remat="save_heavy")


def test_save_heavy_keeps_the_block_inputs_and_the_attention_outputs():
    """The bytes the autograd graph keeps for the backward (distinct
    storages packed by ``saved_tensors_hooks``) on reduced stablelm-1.6b:
    ``full`` keeps the least, ``none`` the most, and ``save_heavy`` keeps
    exactly ``full``'s plus every layer's attention output (the
    reference's ``attn_out``), which ``full`` does not keep."""
    from repro_torch.models import transformer
    _, tc, _, tb, p = both("stablelm-1.6b")
    d = {k: torch.from_numpy(v) for k, v in batch_for(tc).items()}

    def saved(remat):
        bundle = tb if remat == "none" else both("stablelm-1.6b", remat=remat)[3]
        params = ttree.tree_map(lambda t: t.detach().requires_grad_(True),
                                bridge.params_from_numpy(p, "cpu"))
        kept, outs = {}, []
        real = transformer.gqa_apply

        def spy(*a, **k):
            out = real(*a, **k)
            outs.append(out[0])
            return out

        def pack(t):
            kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        transformer.gqa_apply = spy
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                bundle.train_loss(params, d)
        finally:
            transformer.gqa_apply = real
        attn = {a.untyped_storage().data_ptr(): a.untyped_storage().nbytes() for a in outs}
        assert len(attn) == tc.n_layers
        return kept, attn

    none, _ = saved("none")
    full, attn_full = saved("full")
    heavy, attn_heavy = saved("save_heavy")
    assert sum(full.values()) < sum(heavy.values()) < sum(none.values())
    assert not set(attn_full) & set(full)
    assert set(attn_heavy) <= set(heavy)
    assert sum(heavy.values()) == sum(full.values()) + sum(attn_heavy.values())


@pytest.mark.parametrize("quant_state", [False, True])
def test_microbatch_step_matches_jax(quant_state):
    """One ``build_train_step(microbatch=2)`` step from the same params and
    state as the reference's jitted step: loss, grad norm, lr scale, new
    params and moments within the tolerances (codes one apart at most in 1
    of 1000)."""
    arch = "stablelm-1.6b"
    jc, tc, jb, tb, p = both(arch)
    jcfg = jadamw.AdamWConfig(lr=1e-3, quant_state=quant_state)
    tcfg = tadamw.AdamWConfig(lr=1e-3, quant_state=quant_state)
    d = batch_for(jc, batch=4)
    jstep, _ = j_build_step(jb, jcfg, microbatch=2, donate=False)
    jstate = {"params": jax.tree.map(jnp.asarray, p), "opt": jadamw.init(p, jcfg)}
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in d.items()})
    tstep = build_train_step(tb, tcfg, microbatch=2)
    tparams = bridge.params_from_numpy(p, "cpu")
    tnew, tm = tstep({"params": tparams, "opt": tadamw.init(tparams, tcfg)}, d)
    for k in ("loss", "xent", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                                         atol=1e-5),
                 bridge.params_to_numpy(tnew["params"], tc), jnew["params"])
    got = bridge.opt_state_to_numpy(tnew["opt"], tc)
    if quant_state:
        diff = np.concatenate([np.abs(a.astype(np.int32) - np.asarray(b).astype(np.int32))
                               .reshape(-1) for a, b in zip(jax.tree.leaves(got.m),
                                                            jax.tree.leaves(jnew["opt"].m))])
        assert diff.max() <= 1 and diff.mean() <= 1e-3
    else:
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                                             atol=1e-9),
                     got.v, jnew["opt"].v)


def test_refusals_name_their_items():
    _, tc, _, tb, p = both("deepseek-v2-236b")
    params = bridge.params_from_numpy(p, "cpu")
    d = {k: torch.from_numpy(v) for k, v in batch_for(tc).items()}
    with tctx.use_context(tctx.DistContext(mesh=None, token_axes=("data",),
                                           expert_axis="model")):
        with pytest.raises(ValueError, match="dist_context_for"):
            tb.train_loss(params, d)
    assert tctx.get_context() is None


@pytest.mark.parametrize("quant_state", [False, True])
def test_one_entry_mesh_step_is_the_one_device_step(quant_state):
    """``build_train_step`` over a 1x1 mesh under ``dist_context_for`` -
    the sharded step's gathers, reductions, block updates and expert
    parallelism over groups of one - gives the one-device step's metrics,
    params and moments bit for bit (deepseek-v2's routed experts)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import schedule
    from repro_torch.train.train_step import dist_context_for
    _, tc, _, tb, p = both("deepseek-v2-236b")
    opt = tadamw.AdamWConfig(lr=1e-3, quant_state=quant_state)
    d = batch_for(tc, batch=4)
    mesh = make_host_mesh(1, 1, ["cpu"])
    state = {"params": bridge.params_from_numpy(p, "cpu"),
             "opt": tadamw.init(bridge.params_from_numpy(p, "cpu"), opt)}
    one = build_train_step(tb, opt, lr_schedule=schedule.constant, microbatch=2)
    want, wm = one(state, d)
    with tctx.use_context(dist_context_for(mesh)):
        got, gm = build_train_step(tb, opt, mesh, lr_schedule=schedule.constant,
                                   microbatch=2)(state, d)
    assert tctx.get_context() is None
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    for a, b in zip(ttree.leaves(got), ttree.leaves(want)):
        assert torch.equal(a, b)
