"""Port parity, mixture of experts: `singa_tpu_torch.parallel.moe`,
`layer.MoE`, the MoE `TransformerBlock` and the MoE-GPT against the JAX
package on seeded numpy inputs.

- moe_ffn (T 64 and 61, D 32, H 64, E 4; k 1 and 2; capacity factor
  0.5, 1.25 and E; Wg = 0, where every probability ties): y, aux and
  z_loss within 1e-6 of max|ref|, `overflow` equal, the gradients of x,
  Wg, W1, b1, W2 and b2 rtol 1e-4 / atol 1e-5; the index routing of
  topk_gating, made dense, equal to JAX's dispatch and combine;
- the known difference: JAX counts queue positions in the activation
  dtype, and in bf16 it gives two tokens one slot once an expert has
  more than 256; the port's integer positions stay unique;
- the MoE layer (deferred init, names, shapes, forward, gradients, the
  router losses on the layer) and the MoE block with weights carried;
- a GPT(moe_experts=4, moe_k=2) at dim 64, 4 heads, 2 layers, vocab 97
  trains 3 SGD steps on b2 x 16 against JAX (losses rtol 1e-5,
  parameters atol 1e-5; bf16 amp: losses rtol 2e-2, the third step
  from JAX's state after two, see the test for why), graph mode equals
  eager bit for bit on the CPU, and save_states zips load both ways."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.parallel import moe as jmoe
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tl
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import transformer as ttr
from singa_tpu_torch.parallel import moe as tmoe

torch.set_num_threads(2)
D, HID, E = 32, 64, 4
GRAD = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(vocab_size=97, max_seq=64, dim=64, num_heads=4, num_layers=2,
             moe_experts=4, moe_k=2)
B, S, STEPS = 2, 16, 3


def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _moe_args(T, ties):
    return [_r((T, D), 0), _r((D, E), 1, 0.0 if ties else 0.3),
            _r((E, D, HID), 2, 0.2), _r((E, HID), 3, 0.1),
            _r((E, HID, D), 4, 0.2), _r((E, D), 5, 0.1)]


def _close_to_max(got, want, tol=1e-6, what=""):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


CASES = {"t64": (64, False), "t61": (61, False), "ties": (64, True)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cf", [0.5, 1.25, float(E)])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_jax(k, cf, case):
    T, ties = CASES[case]
    args = _moe_args(T, ties)

    def jf(*a):
        y, aux, (z, ovf) = jmoe.moe_ffn(*a, capacity_factor=cf, k=k)
        return y, aux, z, ovf

    jy, jaux, jz, jovf = jf(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    y, aux, (z, ovf) = tmoe.moe_ffn(*targs, capacity_factor=cf, k=k)
    _close_to_max(y.detach().numpy(), jy, what="y")
    _close_to_max(aux.detach().numpy(), jaux, what="aux")
    _close_to_max(z.detach().numpy(), jz, what="z_loss")
    assert float(ovf) == float(jovf)
    if cf == E:
        assert float(ovf) == 0.0
    w = _r((T, D), 6)
    jg = jax.grad(lambda *a: jnp.sum(jf(*a)[0] * w) + jf(*a)[1]
                  + jf(*a)[2], argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux + z,
                             targs)
    for name, g, want in zip(("x", "Wg", "W1", "b1", "W2", "b2"), tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_index_routing_equals_jax_dispatch_and_combine(k):
    """topk_gating's slots and gates, made dense, are JAX's (T, E, C)
    dispatch and combine; with Wg = 0 every token goes to experts 0..k-1
    (the lower index wins a tie), so most routes overflow."""
    for ties in (False, True):
        x, Wg = _moe_args(64, ties)[:2]
        C = 20
        jd, jc, _, _, jovf = jmoe.topk_gating(jnp.asarray(x),
                                              jnp.asarray(Wg), C, k)
        slots, gates, _, _, ovf = tmoe.topk_gating(
            torch.from_numpy(x), torch.from_numpy(Wg), C, k)
        dense_d = np.zeros((64, E * C + 1), np.float32)
        dense_c = np.zeros((64, E * C + 1), np.float32)
        for j in range(k):
            dense_d[np.arange(64), slots[:, j].numpy()] += 1.0
            dense_c[np.arange(64), slots[:, j].numpy()] += \
                gates[:, j].numpy()
        np.testing.assert_array_equal(
            dense_d[:, :-1].reshape(64, E, C), np.asarray(jd))
        np.testing.assert_allclose(dense_c[:, :-1].reshape(64, E, C),
                                   np.asarray(jc), rtol=1e-6, atol=1e-7)
        assert float(ovf) == float(jovf)
        kept = slots[slots < E * C]
        assert len(torch.unique(kept)) == len(kept)
        if ties:
            assert set((kept // C).tolist()) == set(range(k))
            assert float(ovf) == 1.0 - C * k / (64 * k)


def test_bf16_queue_positions_known_difference():
    """600 tokens all routed to expert 0 in bf16 (capacity 1000): JAX's
    bf16 cumsum stops counting at 256 and puts several tokens in one
    slot; the port's integer positions give 600 distinct slots."""
    x = np.ones((600, 8), np.float32)
    Wg = np.zeros((8, 2), np.float32)
    Wg[:, 0] = 1.0
    jd, _, _, _, _ = jmoe.topk_gating(jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(Wg, jnp.bfloat16), 1000, 1)
    occupancy = np.asarray(jd.astype(jnp.float32)).sum(axis=0)
    assert occupancy.max() > 1 and (occupancy > 0).sum() < 600
    slots, _, _, _, ovf = tmoe.topk_gating(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(Wg).bfloat16(),
        1000, 1)
    assert sorted(slots[:, 0].tolist()) == list(range(600))
    assert float(ovf) == 0.0


class _Train:
    """Both packages' global training switch, restored on exit."""

    def __enter__(self):
        self.prev = (jag.training, tag.training)
        jag.training = tag.training = True

    def __exit__(self, *exc):
        jag.training, tag.training = self.prev


def _grads_by_name(grads, params, to_np):
    names = {id(v): k for k, v in params.items()}
    return {names[id(p)]: to_np(g) for p, g in grads.items()
            if id(p) in names}


def test_moe_layer_matches_jax():
    """Deferred init (names, shapes, the init's scales), the forward and
    the gradients of (output, aux, z) with JAX's weights carried, and the
    router losses left on the layer as tape Tensors."""
    x = _r((2, 24, D), 7)
    jdev, tdev = jdevice.best_device(), tdevice.create_cpu_device()
    j = jl.MoE(E, capacity_factor=1.25, k=2)
    t = tl.MoE(E, capacity_factor=1.25, k=2)
    assert not dict(t.named_parameters())
    with _Train():
        j(jt.from_numpy(x, device=jdev))
        t(tt.from_numpy(x, device=tdev))
    jp, tp = j.get_params(), t.get_params()
    assert list(tp) == list(jp) == ["Wg", "W1", "b1", "W2", "b2"]
    assert [tuple(v.shape) for v in tp.values()] \
        == [tuple(v.shape) for v in jp.values()]
    assert abs(float(tp["W1"].data.detach().std()) - (2.0 / D) ** 0.5) \
        < 0.02
    assert not tp["b1"].data.any() and not tp["b2"].data.any()
    assert float(tp["Wg"].data.detach().abs().max()) \
        <= (6.0 / (D + E)) ** 0.5
    t.set_params({k: jt.to_numpy(v) for k, v in jp.items()})
    with _Train():
        jy = j(jt.from_numpy(x, device=jdev))
        ty = t(tt.from_numpy(x, device=tdev))
        _close_to_max(ty.numpy(), jt.to_numpy(jy), what="y")
        for a in ("aux_loss", "z_loss", "overflow"):
            assert isinstance(getattr(t, a), tt.Tensor)
            _close_to_max(getattr(t, a).numpy(),
                          jt.to_numpy(getattr(j, a)), what=a)
        target = _r((2, 24, D), 8)
        jl_ = jag.add(jag.add(
            jag.mse_loss(jy, jt.from_numpy(target, device=jdev)),
            j.aux_loss), j.z_loss)
        tl_ = tag.add(tag.add(
            tag.mse_loss(ty, tt.from_numpy(target, device=tdev)),
            t.aux_loss), t.z_loss)
        want = _grads_by_name(jag.gradients(jl_), jp, jt.to_numpy)
        got = _grads_by_name(tag.gradients(tl_), tp,
                             lambda g: g.numpy())
    assert sorted(got) == sorted(want) == sorted(jp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD, err_msg=k)


def test_moe_block_matches_jax():
    """The MoE TransformerBlock (no fc1/fc2; x + moe(ln2(x))) with JAX's
    weights: output and its router losses."""
    x = _r((2, 16, 64), 9)
    jdev = jdevice.best_device()
    j = jl.TransformerBlock(4, moe_experts=4, moe_k=2)
    with _Train():
        j(jt.from_numpy(x, device=jdev))
    t = tl.TransformerBlock(4, moe_experts=4, moe_k=2, dim=64,
                            generator=torch.Generator().manual_seed(0))
    assert not hasattr(t, "fc1") and t.moe.k == 2
    assert list(t.get_params()) == list(j.get_params())
    t.set_params({k: jt.to_numpy(v) for k, v in j.get_params().items()})
    with _Train():
        jy = j(jt.from_numpy(x, device=jdev))
    got = t(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(got.numpy(), jt.to_numpy(jy), atol=1e-5,
                               rtol=1e-5)
    _close_to_max(float(t.moe.aux_loss.detach()),
                  jt.to_numpy(j.moe.aux_loss),
                  what="aux")
    assert float(t.moe.overflow) == float(jt.to_numpy(j.moe.overflow))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 97, (B, S)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _pair(amp=None, use_graph=True, **kw):
    """A JAX MoE-GPT compiled for training and the port's holding its
    initial parameters, both with SGD + momentum."""
    ids, _ = _batch()
    jdevice.best_device().SetRandSeed(0)
    jm = jmodels.create_model("gpt", **SMALL, **kw)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    jm.compile([jt.from_numpy(ids, device=jdevice.best_device())],
               is_train=True, use_graph=True, amp=amp)
    tm = ttr.GPT(**SMALL, **kw, device="cpu")
    ttr.load_singa_params(
        tm, {k: jt.to_numpy(v) for k, v in jm.get_params().items()})
    tm.set_optimizer(topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    tm.compile([torch.from_numpy(ids)], is_train=True, use_graph=use_graph,
               amp=amp)
    return jm, tm


def _train(jm, tm, steps=STEPS):
    ids, tgt = _batch()
    jdev = jdevice.best_device()
    tx, ty = jt.from_numpy(ids, device=jdev), jt.from_numpy(tgt, device=jdev)
    jls, tls = [], []
    for _ in range(steps):
        jls.append(float(jt.to_numpy(jm(tx, ty)[1])))
        tls.append(tm(torch.from_numpy(ids), torch.from_numpy(tgt))[1].item())
    return np.array(jls), np.array(tls)


def test_moe_gpt_training_matches_jax():
    """Three steps with routes dropping (b2 x 16 = 32 tokens, capacity
    int(32 * 2 * 1.25 / 4) = 20 a layer): losses with the router losses
    folded in, then every parameter and the optimizer's states."""
    jm, tm = _pair()
    assert list(tm.get_params()) == list(jm.get_params())
    jls, tls = _train(jm, tm)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    assert any(float(b.moe.overflow) > 0 for b in tm.blocks)
    for k, v in jm.get_params().items():
        np.testing.assert_allclose(tm.get_params()[k].numpy(),
                                   jt.to_numpy(v), atol=1e-5, rtol=0,
                                   err_msg=k)
    js, ts = jm.optimizer.get_states(), tm.optimizer.get_states()
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_moe_gpt_router_losses_in_the_loss():
    """The loss is the cross-entropy plus, block by block, aux * 0.01
    and z * 1e-3."""
    tm = ttr.GPT(**SMALL, device="cpu")
    ids, tgt = _batch()
    logits = tm(torch.from_numpy(ids))
    ce = tm.sce(logits.reshape(-1, 97), torch.from_numpy(tgt).reshape(-1)
                .long())
    want = ce
    for b in tm.blocks:
        want = want + b.moe.aux_loss * 0.01 + b.moe.z_loss * 1e-3
    got = tm._moe_losses(ce)
    assert float(got) == float(want) and float(got) > float(ce)


def test_moe_gpt_bf16_amp_close_to_jax():
    """Under amp the residual stream is fp32 (learned positions), so the
    router and the experts run fp32 in both packages, as the JAX MoE
    layer never casts. The first two losses are held at the dense GPT's
    2e-2. Routing is discontinuous: the bf16 attention's rounding moves
    the gate probabilities by up to 7e-3, and in the first step a token
    of layer 1 has its second and third experts 3.5e-4 apart, so the two
    packages' bf16 runs may route it differently; after two SGD steps at
    lr 0.1 with momentum their third losses part by about 2e-2 (2.353
    against 2.305). So the third step starts from JAX's parameters and
    optimizer states after two steps, carried into the port, and its
    loss is held at 2e-2 too."""
    jm, tm = _pair(amp="bfloat16")
    jls, tls = _train(jm, tm, steps=STEPS - 1)
    np.testing.assert_allclose(tls, jls, rtol=2e-2)
    ttr.load_singa_params(
        tm, {k: jt.to_numpy(v) for k, v in jm.get_params().items()})
    tm.optimizer.set_states(jm.optimizer.get_states())
    j3, t3 = _train(jm, tm, steps=1)
    np.testing.assert_allclose(t3, j3, rtol=2e-2)
    assert np.isfinite(t3).all() and t3[0] < tls[0]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert tag.compute_dtype is None


def test_moe_gpt_graph_equals_eager_bitwise():
    _, tg = _pair()
    _, te = _pair(use_graph=False)
    ids, tgt = (torch.from_numpy(a) for a in _batch())
    lg = [float(tg(ids, tgt)[1]) for _ in range(STEPS)]
    le = [float(te(ids, tgt)[1]) for _ in range(STEPS)]
    assert tg.graph_backend == "eager" and te.graph_backend is None
    assert lg == le
    se, sg = te._raw_states(), tg._raw_states()
    assert all(torch.equal(se[k], sg[k]) for k in se)


def test_moe_gpt_checkpoints_load_both_ways(tmp_path):
    jm, tm = _pair()
    _train(jm, tm, steps=2)
    ids, _ = _batch(seed=3)
    jdev = jdevice.best_device()
    port_zip = os.path.join(tmp_path, "port.zip")
    tm.save_states(port_zip)
    j2 = jmodels.create_model("gpt", **SMALL)
    j2.compile([jt.from_numpy(ids, device=jdev)], is_train=False,
               use_graph=False)
    j2.load_states(port_zip)
    j2.eval()
    tm.eval()
    want = jt.to_numpy(j2(jt.from_numpy(ids, device=jdev)))
    np.testing.assert_allclose(tm(torch.from_numpy(ids)).numpy(), want,
                               atol=1e-4, rtol=1e-4)
    jax_zip = os.path.join(tmp_path, "jax.zip")
    jm.save_states(jax_zip)
    t2 = ttr.GPT(**SMALL, device="cpu", seed=9)
    t2.load_states(jax_zip)
    for k, v in jm.get_params().items():
        np.testing.assert_array_equal(t2.get_params()[k].numpy(),
                                      jt.to_numpy(v))
