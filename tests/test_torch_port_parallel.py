"""Data parallelism of the port (``parallel/``, the sharded train and eval
steps, the rank gather; the CLIs in ``test_torch_port_parallel_cli.py``) on the CPU: 2 gloo ranks
started as processes (``tests/torch_port_ranks.py``, a rendezvous on a
free local port, a hard timeout a launch) against
the port's single-process steps and files, and against the JAX package's
``make_train_step(mesh=...)`` on the conftest's 8 virtual devices.

Bars: without dropout the JAX package's own (``tests/test_sharding.py``:
loss 1e-4 relative, parameters 1e-5); with dropout 1e-6 against the mean
of the ranks' local steps emulated in one process, each with its rank's
seed; rows of the test CLI exactly equal to the ``--shard`` /
``--merge-shards`` files.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState as JaxTrainState

import torch_port_ranks as ranks
from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu.parallel import mesh as jmesh
from mri_inr_tpu.train import losses as jlosses
from mri_inr_tpu.train import trainer as jtrainer
from mri_inr_tpu_torch.eval import evaluate as ev
from mri_inr_tpu_torch.interop import params_from_flax, params_to_flax
from mri_inr_tpu_torch.parallel import distributed, mesh
from mri_inr_tpu_torch.train import losses, trainer

# the test workers share the cores: one torch thread each
torch.set_num_threads(1)

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return ranks.run_scenario("steps", 2, tmp_path_factory.mktemp("steps"))


def _batch():
    return tuple(torch.from_numpy(a) for a in ranks.global_batch())


def _single(case):
    """The port's one-process run of a ``steps`` case."""
    dropout, fused, opt, lr, n = ranks.STEP_CASES[case]
    model = ranks.small_model(dropout, "cpu")
    state = trainer.create_train_state(model, opt, lr)
    step = trainer.make_train_step(model, losses.mse, 32, 24, use_pallas=fused,
                                   sin5=case != "sgd1")
    fully, under = _batch()
    got = [float(step(state, fully, under, ranks.BASE_SEED)) for _ in range(n)]
    return np.array(got), ranks.flat_params(model)


# ----------------------------------------------------------------- layout
def test_local_rows_are_the_jax_mesh_layout():
    fully, _ = ranks.global_batch()
    sharded = jmesh.shard_batch(jmesh.make_mesh(2), jnp.asarray(fully))
    for shard in sharded.addressable_shards:
        r = shard.index[0].start // (len(fully) // 2)
        np.testing.assert_array_equal(np.asarray(shard.data), mesh.local_rows(fully, r, 2))
    assert [len(mesh.local_rows(torch.zeros(400, 2), r, 2)) for r in (0, 1)] == [200, 200]
    with pytest.raises(ValueError, match="divisible"):
        mesh.local_rows(fully[:15], 0, 2)


# ----------------------------------------------------------------- routes
@pytest.fixture
def clean_env(monkeypatch):
    for var in (*distributed.TRIPLE, "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_launch_routes(clean_env):
    assert distributed._launch() is None
    clean_env.setenv("RANK", "1")
    clean_env.setenv("WORLD_SIZE", "4")
    clean_env.setenv("LOCAL_RANK", "1")
    assert distributed._launch() == ("env://", 1, 4, 1)
    clean_env.setenv("MRI_INR_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="set together"):
        distributed._launch()
    clean_env.setenv("MRI_INR_NUM_PROCESSES", "2")
    clean_env.setenv("MRI_INR_PROCESS_ID", "1")
    assert distributed._launch() == ("tcp://localhost:1234", 1, 2, 1)
    clean_env.delenv("LOCAL_RANK")
    clean_env.setenv("MRI_INR_COORDINATOR", "file:///tmp/rdv")
    assert distributed._launch() == ("file:///tmp/rdv", 1, 2, 1)


def test_one_process_makes_no_group(clean_env):
    """Without a route (or with one rank) nothing is joined: the run stays
    the single-process one."""
    assert distributed.initialize("cpu") == torch.device("cpu")
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "1")
    assert distributed.initialize("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_primary() and distributed.collective_group() is None
    assert distributed.all_gather_host_values({"a": 1}) == [{"a": 1}]
    assert distributed.broadcast_from_primary("ts") == "ts"
    assert distributed.any_rank(True) and not distributed.any_rank(False)
    distributed.sync_hosts("nothing to wait for")


def test_a_rank_past_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="at or past the 1 card"):
        distributed._rank_device(None, 1)


def test_a_rendezvous_without_its_peers_raises_within_the_timeout(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update({"MRI_INR_COORDINATOR": f"127.0.0.1:{ranks.free_port()}",
                "MRI_INR_NUM_PROCESSES": "2", "MRI_INR_PROCESS_ID": "0",
                "MRI_INR_DIST_TIMEOUT": "3"})
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", "from mri_inr_tpu_torch.parallel import distributed\n"
         "distributed.initialize('cpu')"],
        cwd=ranks.ROOT, env=env, capture_output=True, text=True, timeout=90)
    assert proc.returncode != 0
    assert time.monotonic() - t0 < 60, "the rendezvous outlived its timeout"
    assert "timeout" in proc.stderr.lower() or "timed out" in proc.stderr.lower(), proc.stderr


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("case", list(ranks.STEP_CASES))
def test_the_ranks_hold_one_model(steps, case):
    """One all-reduce of loss and gradients, then the same optimizer step:
    both ranks end with the same parameters and losses."""
    np.testing.assert_array_equal(steps[0][f"{case}_params"], steps[1][f"{case}_params"])
    np.testing.assert_array_equal(steps[0][f"{case}_loss"], steps[1][f"{case}_loss"])


@pytest.mark.parametrize("case", ["sgd3", "sgd1", "module2"])
def test_sharded_step_matches_one_process_without_dropout(steps, case):
    """SGD, as the JAX package's test: Adam's first steps move an element
    whose gradient is rounding noise by about ``lr`` either way."""
    want_loss, want_params = _single(case)
    np.testing.assert_allclose(steps[0][f"{case}_loss"], want_loss, rtol=1e-4)
    np.testing.assert_allclose(steps[0][f"{case}_params"], want_params, rtol=0, atol=1e-5)
    assert np.abs(steps[0][f"{case}_params"]
                  - ranks.flat_params(ranks.small_model(0.0, "cpu"))).max() > 1e-4


@pytest.mark.parametrize("case", ["dropout1", "dropout_sgd1"])
def test_sharded_step_with_dropout_is_the_mean_of_the_ranks_local_steps(steps, case):
    """Each rank drops with its own stream (the step's seed with the rank
    folded in); the step equals the optimizer on the mean of the two local
    gradients, each computed here in one process with its rank's seed."""
    want, loss = ranks.emulate_step(case, "cpu", 2)
    np.testing.assert_allclose(steps[0][f"{case}_params"], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(steps[0][f"{case}_loss"][0], loss, rtol=1e-6)
    # the two ranks' streams differ: each is the JAX mesh step's stream of
    # its axis index, randint(fold_in(fold_in(key(b), s), rank))
    assert trainer.step_seed(ranks.BASE_SEED, 0, 1) != trainer.step_seed(ranks.BASE_SEED, 0, 0)
    for r in (0, 1):
        want = [int(jax.random.randint(jax.random.fold_in(jax.random.fold_in(
            jax.random.key(ranks.BASE_SEED), s), r), (1,), 0, 2**23)[0]) for s in range(4)]
        np.testing.assert_array_equal(trainer.epoch_seeds(ranks.BASE_SEED, 0, 4, r), want)
        assert [trainer.step_seed(ranks.BASE_SEED, s, r) for s in range(4)] == want


def test_sharded_step_matches_the_jax_mesh_step(steps):
    """JAX's fused step under ``shard_map`` over 8 virtual devices (its
    kernels interpreted), dropout off, one SGD step from the port's initial
    weights, against the port's step over 2 ranks (the JAX test's bars)."""
    model = ranks.small_model(0.0, "cpu")
    jm = JaxModel(dropout=0.0, **ranks.WIDTHS)
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    state = JaxTrainState.create(apply_fn=jm.apply, params=params,
                                 tx=jtrainer.make_optimizer("sgd", 1e-2))
    m = jmesh.make_mesh()
    step = jtrainer.make_train_step(jm, jlosses.mse, 32, 24, mesh=m, use_pallas=True,
                                    interpret=True)
    fully, under = jmesh.shard_batch(m, *(jnp.asarray(a) for a in ranks.global_batch()))
    state, loss = step(state, fully, under, jax.random.key(0))
    assert float(steps[0]["sgd1_loss"][0]) == pytest.approx(float(loss), rel=1e-4)
    want = params_from_flax(jax.device_get(state.params))
    model.load_state_dict(want)
    np.testing.assert_allclose(steps[0]["sgd1_params"], ranks.flat_params(model), rtol=0,
                               atol=1e-5)


def test_sharded_eval_step_matches_one_process(steps):
    model = ranks.small_model(0.0, "cpu")
    eval_step = trainer.make_eval_step(model, losses.mse, 32, 24, use_pallas=True, sin5=True,
                                       device="cpu")
    assert float(steps[0]["eval_loss"]) == pytest.approx(float(eval_step(None, *_batch())),
                                                         rel=1e-4)
    assert steps[0]["eval_loss"] == steps[1]["eval_loss"]


def test_gather_shard_results_over_ranks_equals_the_merged_shards(tmp_path):
    got = [ranks.run_scenario("gather", 2, tmp_path / "ranks")[r]["rows"] for r in (0, 1)]
    assert got[0] == got[1]  # every rank returns the combined list
    rows = [ev.SliceResult(f"slice_{i}", 20.0 + i / 3, 0.5 + i / 7, 0.1 / (i + 1))
            for i in range(5)]
    for r in (0, 1):  # shards of 3 and 2 rows, as --shard r:2 writes them
        ev.write_metrics_artifacts(rows[r::2], tmp_path / "merge" / f"metrics_shard{r}_2")
    merged = ev.merge_shard_csvs(tmp_path / "merge")
    assert [ev.SliceResult(*row) for row in json.loads(str(got[0]))] == merged
