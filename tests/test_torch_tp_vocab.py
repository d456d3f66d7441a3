"""Port parity, the vocab-parallel GPT on gloo ranks against JAX's, with
test_torch_tp_gpt.py's helpers and job (its docstring gives the meshes
and tolerances), here over the vocab-parallel cases:

- The vocab-parallel GPT (tests/test_parallel_extra.py:131: vocab 50
  padded to 56, the head tied): 3 steps; each rank holds 56 / tp rows of
  the table; the gathered logits (B, S, 50) within atol 1e-5 of JAX's;
  JAX's `save_states` zip of its initial weights loaded into the trained,
  sharded model (`load_singa_states`) repeats JAX's losses.
- Predictions only (:204: vocab 48, 1 layer, SGD(0.0)): the (B, S)
  int32 argmax equals JAX's and the argmax of the gathered logits; the
  loss equals the logits run's within 1e-5.
- `vocab_tp` without `tp_axis` raises ValueError naming tp_axis (:195).
- The sharded checkpoint (tests/test_model.py:353, in the port's own
  format): 2 steps, a save, a fresh mesh-compiled model restores it and
  its next 2 losses equal the uninterrupted run's within rtol 1e-5; the
  files hold the global (48, 16) table (vocab 48), each rank 48 / tp
  rows; the uninterrupted run matches JAX's.
- Dryrun step 2b's TP GPT (`__graft_entry__.py:247-272`) on its own mesh
  ({data 1, tp 2} at 2 ranks, {data 1, tp 4} at 4): one step, the loss
  and the parameters against JAX's, 56 / tp rows of the table a rank.
"""

import numpy as np
import pytest
import torch

from singa_tpu_torch import models as tmodels
from test_torch_tp_gpt import (check_bridge, check_matches_jax,
                               check_shards, run_cases)
from torch_dist_worker import tp_gpt_mesh_shape

torch.set_num_threads(2)

CASES = ("vocab", "preds", "ckpt", "dry2b")


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, tmp_path_factory):
    return run_cases(request.param, CASES, tmp_path_factory)


@pytest.mark.parametrize("case", ["vocab", "dry2b"])
def test_vocab_parallel_gpt_matches_jax(runs, case):
    check_matches_jax(runs, case)


@pytest.mark.parametrize("case", ["vocab", "dry2b"])
def test_each_rank_holds_its_rows(runs, case):
    check_shards(runs, case)


def test_jax_states_load_into_the_sharded_model(runs):
    check_bridge(runs, "vocab")


def test_vocab_parallel_logits_are_gathered_and_sliced(runs):
    world, jax_res, port = runs
    want = jax_res["vocab"]["out"]
    for r in port:
        assert r["vocab/out"].shape == want.shape == (4, 16, 50)
        np.testing.assert_allclose(r["vocab/out"], want, atol=1e-5)


def test_predictions_only(runs):
    world, jax_res, port = runs
    for r in port:
        preds, logits = r["preds/pred/out"], r["preds/full/out"]
        assert preds.shape == (4, 8) and preds.dtype == np.int32
        np.testing.assert_array_equal(preds, jax_res["preds/pred"])
        np.testing.assert_array_equal(preds, np.argmax(logits, axis=-1))
        assert abs(r["preds/pred/losses"][0]
                   - r["preds/full/losses"][0]) < 1e-5
        np.testing.assert_allclose(r["preds/full/losses"],
                                   jax_res["preds"]["losses"], rtol=1e-5)


def test_vocab_tp_requires_tp_axis():
    with pytest.raises(ValueError, match="tp_axis"):
        tmodels.create_model("gpt", vocab_size=50, vocab_tp=True,
                             device="cpu")


def test_sharded_checkpoint_resumes(runs):
    world, jax_res, port = runs
    tp = tp_gpt_mesh_shape("ckpt", world)["tp"]
    for r in port:
        np.testing.assert_allclose(r["ckpt/got"], r["ckpt/ref"][2:],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["ckpt/ref"], jax_res["ckpt"]["losses"],
                                   rtol=1e-5)
        # vocab 48 is a multiple of 8 already: no padding
        assert int(r["ckpt/file_rows"]) == 48
        assert int(r["ckpt/local_rows"]) == 48 // tp
