"""Port parity, pipeline parallelism through the Model API on gloo ranks
against JAX (`torch_dist_worker.job_pp_gpt`, one job a world size): JAX
trains the same PipelinedGPTs in this process on 2, 4 and 8 of its
virtual CPU devices (`pp_gpt_cases`).

- {data 1, pp 4}: tests/test_parallel_extra.py's 4-layer model on gpipe
  and on 1f1b at n_micro 4 (:244-335), GQA on gpipe (:761) and RoPE on
  1f1b (:806).
- Dryrun step 2b's pipeline cases (`__graft_entry__.py:272-317`) at 2 and
  4 ranks: num_layers world + 1 (non-uniform stages: the stacks padded,
  late stages run fewer layers) on gpipe at n_micro 2 and on 1f1b at 4,
  and interleave 2 over 2 world - 1 layers at n_micro world (7 layers at
  4 ranks).
- At 8 ranks, one job: pp x ep on {data 2, pp 2, ep 2} under
  DistOpt(axis=("data", "ep")) with the router losses on (:319-341), the
  3-D {data 2, pp 2, tp 2} with vocab_tp on 1f1b (:352-377), and the
  vocab-parallel model on {data 2, pp 4}, a mesh without its tp axis, on
  1f1b (tests/test_parallel_extra.py:617).

Each case starts from JAX's initial weights (`load_singa_params` for
every other case, `set_params` for the rest) and takes 3 SGD(0.05)
steps: the losses within relative 1e-4 and the global parameters within
absolute 1e-4 of JAX's, on every rank alike; the port's pipelined losses
within 2e-3 of its own serial path (plain SGD, no pipeline axis; JAX's
own tolerance, tests/test_parallel_extra.py:280) for the dense models;
each rank holds padded_layers / pp stack rows. JAX's GPTs run their
attention through its plain reference.

In this process: the RoPE stacks of a serial PipelinedGPT trained in a
port GPT (tests/test_parallel_extra.py:865-895), within 2e-3; JAX's
ValueErrors for the combinations it refuses, with its messages; and the
gathered `save_states` zip of the {data 1, pp 2} dryrun gpipe model
loaded into a serial one.
"""

import concurrent.futures
import functools
import os

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.parallel import make_mesh as jmake_mesh
from test_torch_sp import jax_plain_attention, jax_rng_kept
from torch_dist_worker import (PP_DRY, PP_SMALL, PP_STEPS, pp_gpt_case,
                               pp_gpt_cases, pp_gpt_data, run_job)

torch.set_num_threads(2)

WORLDS = (2, 4, 8)
#: the CPU cores a job's ranks share (run_job's `cpus`)
JOB_CPUS = 2
CASES = [(w, c) for w in WORLDS for c in pp_gpt_cases(w)]


def _jax_pp(case, world, ids, tgt):
    """JAX's PipelinedGPT of `case` under DistOpt(SGD(0.05)) on its mesh,
    compiled: (initial global weights, a function that trains PP_STEPS
    steps and returns (losses, global parameters))."""
    dev = jdevice.get_default_device()
    cfg, mesh, axis, comp = pp_gpt_case(case, world)
    m = jmodels.create_model("gpt_pipe", **cfg)
    m.set_optimizer(jopt.DistOpt(jopt.SGD(lr=0.05), axis=axis,
                                 mesh=jmake_mesh(mesh)))
    tx, ty = jt.from_numpy(ids, dev), jt.from_numpy(tgt, dev)
    m.compile([tx], is_train=True, use_graph=True, pipeline_axis="pp",
              **comp)

    def run():
        losses = [float(jt.to_numpy(m(tx, ty)[1])) for _ in range(PP_STEPS)]
        return np.asarray(losses), {k: jt.to_numpy(v)
                                    for k, v in m.get_params().items()}

    return {k: jt.to_numpy(v).copy() for k, v in m.get_params().items()}, run


@functools.lru_cache(maxsize=None)
def _runs(world, root):
    """(JAX's results, the port's rank results, the job's directory) at
    `world` ranks; the port's job (its ranks forked from one launcher, on
    JOB_CPUS cores) runs beside JAX's side."""
    inputs, todo = {}, {}
    with jax_rng_kept(), jax_plain_attention():
        for case in pp_gpt_cases(world):
            ids, tgt = pp_gpt_data(case, world)
            w0, todo[case] = _jax_pp(case, world, ids, tgt)
            inputs.update({f"{case}_ids": ids, f"{case}_tgt": tgt})
            inputs.update({f"{case}_w0/{k}": v for k, v in w0.items()})
    tmp = os.path.join(root, f"pp{world}")
    job = functools.partial(run_job, "pp_gpt", world, tmp, inputs,
                            timeout=240, cpus=JOB_CPUS, forked=True)

    def jax_side():
        with jax_rng_kept(), jax_plain_attention():
            return {k: fn() for k, fn in todo.items()}

    work = os.path.join(tmp, "pp_gpt")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(job)
        return jax_side(), port.result(), work


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pp_gpt"))
    return lambda world: _runs(world, root)


@pytest.mark.parametrize("world,case", CASES)
def test_pipelined_gpt_matches_jax(runs, world, case):
    want, port, _ = runs(world)
    losses, params = want[case]
    for r in port:
        np.testing.assert_allclose(r[f"{case}/losses"], losses, rtol=1e-4)
        got = {k[len(case) + 3:]: v for k, v in r.items()
               if k.startswith(f"{case}/p/")}
        assert list(got) == list(params)
        for k, v in params.items():
            np.testing.assert_allclose(got[k], v, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_pipelined_gpt_matches_its_serial_path(runs, world):
    _, port, _ = runs(world)
    for case in pp_gpt_cases(world):
        cfg, mesh, _, comp = pp_gpt_case(case, world)
        if "moe_experts" in cfg:
            continue    # capacity per microbatch: another routing
        np.testing.assert_allclose(port[0][f"{case}/losses"],
                                   port[0][f"{case}/serial"], atol=2e-3,
                                   err_msg=case)
        L, n = cfg["num_layers"], mesh["pp"]
        per = -(-L // (n * cfg.get("interleave", 1)))
        for r in port:
            assert int(r[f"{case}/rows"]) == per, case


def test_save_states_of_a_pp2_model_loads_into_a_serial_one(runs):
    from singa_tpu_torch import models
    from singa_tpu_torch.model import _read_states_zip
    _, port, work = runs(2)
    zips = [_read_states_zip(os.path.join(work, f"states{r}.zip"))
            for r in range(2)]
    assert sorted(zips[0]) == sorted(zips[1])
    for k, v in zips[0].items():
        np.testing.assert_array_equal(zips[1][k], v)
    cfg = pp_gpt_case("dry_gpipe", 2)[0]
    m = models.create_model("gpt_pipe", device="cpu", **cfg)
    m.set_params(zips[0])
    L = cfg["num_layers"]
    assert zips[0]["Wq"].shape[0] == 4 and not zips[0]["Wq"][L:].any()
    for k, v in m.get_params().items():
        glob = port[0][f"dry_gpipe/p/{k}"]
        np.testing.assert_array_equal(
            v.numpy(), glob[:L] if k in m._stack_attrs else glob,
            err_msg=k)


def test_rope_stacks_train_in_a_gpt():
    """tests/test_parallel_extra.py:865-895: a serial RoPE PipelinedGPT's
    stacks, row by row, in a RoPE GPT: the same two losses within
    2e-3."""
    from singa_tpu_torch import models, opt
    cfg = dict(PP_SMALL, pos_encoding="rope")
    ids, tgt = (torch.as_tensor(a) for a in pp_gpt_data("rope", 4))
    pipe = models.create_model("gpt_pipe", device="cpu", **cfg)
    pipe.set_optimizer(opt.SGD(lr=0.05))
    pipe.compile([ids], is_train=True, use_graph=True)
    assert "pos_embed" not in pipe.get_params()
    gpt = models.create_model("gpt", device="cpu", **cfg)
    gpt.set_optimizer(opt.SGD(lr=0.05))
    gpt.compile([ids], is_train=True, use_graph=True)
    st = pipe.canonical_stacks()
    names = {"g1": "ln1.gamma", "b1": "ln1.beta", "Wq": "attn.Wq",
             "Wk": "attn.Wk", "Wv": "attn.Wv", "Wo": "attn.Wo",
             "g2": "ln2.gamma", "b2": "ln2.beta", "W1": "fc1.W",
             "bb1": "fc1.b", "W2": "fc2.W", "bb2": "fc2.b"}
    params = {f"TransformerBlock_{i}.{v}": st[k][i]
              for k, v in names.items()
              for i in range(cfg["num_layers"])}
    params.update({k: v.numpy() for k, v in pipe.get_params().items()
                   if k not in names})
    gpt.set_params(params)
    for _ in range(2):
        l_pipe = pipe(ids, tgt)[1].item()
        l_gpt = gpt(ids, tgt)[1].item()
    assert abs(l_pipe - l_gpt) < 2e-3, (l_pipe, l_gpt)


def _refusals(models, opt, mesh_fn, ids, dev):
    """The messages of the combinations JAX refuses: at construction
    (moe with tp, interleave or GQA; vocab_tp without tp) and at compile
    (1f1b with interleave or moe)."""
    out = []
    for cfg in (dict(moe_experts=4, tp_axis="tp"),
                dict(moe_experts=4, interleave=2),
                dict(moe_experts=4, num_kv_heads=1),
                dict(vocab_tp=True)):
        with pytest.raises(ValueError) as e:
            models.create_model("gpt_pipe", **dict(PP_DRY, num_layers=2,
                                                   **cfg), **dev)
        out.append(str(e.value))
    for cfg in (dict(interleave=2), dict(moe_experts=4)):
        m = models.create_model("gpt_pipe", **dict(PP_DRY, num_layers=4,
                                                   **cfg), **dev)
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.05), axis="data",
                                    mesh=mesh_fn({"data": 1})))
        with pytest.raises(ValueError) as e:
            m.compile([ids], is_train=True, use_graph=True,
                      pipeline_axis="pp", n_micro=2,
                      pipeline_schedule="1f1b")
        out.append(str(e.value))
    return out


def test_refusals_match_jax():
    from singa_tpu_torch import models, opt
    from singa_tpu_torch.parallel import make_mesh
    ids = np.zeros((4, 8), np.int32)
    got = _refusals(models, opt, make_mesh, torch.as_tensor(ids),
                    dict(device="cpu"))
    with jax_rng_kept():
        want = _refusals(jmodels, jopt, jmake_mesh, jt.from_numpy(
            ids, jdevice.get_default_device()), {})
    assert got == want


@pytest.mark.parametrize("cfg", [dict(PP_SMALL, num_layers=5, interleave=2),
                                 dict(PP_DRY, num_layers=3, moe_experts=4)])
def test_stacks_are_the_jax_draws(cfg):
    """The stacks drawn at construction equal, bit for bit, those the JAX
    PipelinedGPT draws at its first forward (np.random.RandomState(0);
    interleaved (V, n pc) layout with its zero padding rows; MoE
    experts)."""
    from singa_tpu_torch import models
    ids = np.zeros((2, 8), np.int32)
    with jax_rng_kept(), jax_plain_attention():
        j = jmodels.create_model("gpt_pipe", **cfg)
        j.set_optimizer(jopt.SGD(lr=0.05))
        j.compile([jt.from_numpy(ids, jdevice.get_default_device())],
                  is_train=True)
        want = {k: jt.to_numpy(v) for k, v in j.get_params().items()}
    m = models.create_model("gpt_pipe", device="cpu", **cfg)
    for k in m._stack_attrs:
        np.testing.assert_array_equal(m.get_params()[k].numpy(), want[k],
                                      err_msg=k)
