"""The port's Train (``ray_tpu_torch.train``) on the CPU: counterparts of
tests/test_train.py's cases on ``TorchTrainer``, checkpoints of tensor
pytrees, a restart from the latest checkpoint after a worker dies, the
torch backend's device handling, and a tiny GPT-2 trained through the
trainer against the same steps in JAX/optax.  One port cluster for the
file; every wait is bounded."""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch import data as rdata
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchPredictor,
    TorchTrainer,
    session,
)
from ray_tpu_torch.train.worker_group import TrainWorker

RESTORE_RANKS = 4


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    yield
    rt.shutdown()


def test_single_worker_reports_metrics():
    def loop(config):
        for step in range(3):
            session.report({"step": step, "loss": 1.0 / (step + 1)})

    result = TorchTrainer(loop,
                          scaling_config=ScalingConfig(num_workers=1)).fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_history) == 3


def test_multi_worker_ranks():
    def loop(config):
        session.report({"rank": session.get_world_rank(),
                        "world": session.get_world_size()})

    result = TorchTrainer(loop,
                          scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.error is None
    assert result.metrics["world"] == 2
    assert result.metrics["rank"] == 0  # the trainer keeps rank 0's rows


def test_train_loop_config_passed():
    def loop(config):
        session.report({"doubled": config["x"] * 2})

    trainer = TorchTrainer(loop, train_loop_config={"x": 21},
                           scaling_config=ScalingConfig(num_workers=1))
    assert trainer.fit().metrics["doubled"] == 42


def test_checkpoints_persisted_and_retained(tmp_path):
    def loop(config):
        for step in range(3):
            ckpt = Checkpoint.from_dict({"weights": [step] * 3,
                                         "metrics": {"step": step}})
            session.report({"step": step}, checkpoint=ckpt)

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(
            storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=2))).fit()
    assert result.checkpoint is not None
    # dict -> dir -> dict round trips keep types (manifest-tracked)
    assert result.checkpoint.to_dict()["weights"] == [2, 2, 2]
    kept = sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("checkpoint_"))
    assert kept == ["checkpoint_000002", "checkpoint_000003"]


def test_user_error_not_retried(tmp_path):
    attempts = tmp_path / "attempts"

    def loop(config):
        with open(config["attempts"], "a") as f:
            f.write("x")
        raise ValueError("bad hyperparameters")

    result = TorchTrainer(
        loop, train_loop_config={"attempts": str(attempts)},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert result.error is not None
    assert "bad hyperparameters" in result.error
    assert attempts.read_text() == "x"


def test_torch_training_loop_on_workers():
    """A torch training loop (CPU) inside a two-worker gang: the
    counterpart of the JAX package's jax loop on workers."""

    def loop(config):
        import torch

        w = torch.zeros(4, requires_grad=True)
        opt = torch.optim.SGD([w], lr=0.1)
        x, y = torch.ones(8, 4), torch.full((8,), 2.0)
        for _ in range(20):
            opt.zero_grad()
            loss = ((x @ w - y) ** 2).mean()
            loss.backward()
            opt.step()
        session.report({"final_loss": loss.item()})

    result = TorchTrainer(loop,
                          scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.error is None
    assert result.metrics["final_loss"] < 0.1


def test_torch_trainer_ddp_gloo():
    """Two CPU workers join a gloo process group at rank 0's TCP store;
    an allreduce averages their "gradients" like DDP."""

    def loop(config):
        import torch
        import torch.distributed as dist

        rank, world = session.get_world_rank(), session.get_world_size()
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_rank() == rank and dist.get_world_size() == world
        t = torch.full((4,), float(rank))
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        session.report({"avg0": float(t[0]) / world, "rank": rank})

    result = TorchTrainer(loop,
                          scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.error is None, result.error
    assert result.metrics["avg0"] == (0 + 1) / 2


def test_rl_trainer_waits_for_rllib():
    """The JAX package's RLTrainer runs an RLlib algorithm: the port's is
    exported now that its rllib is whole (its run is
    ``tests/test_torch_rllib_ddppo.py``), and so are the framework
    trainers and ``HuggingFacePredictor``: no name of the JAX package's
    ``ray_tpu.train`` waits for a later slice."""
    import ray_tpu_torch.train as train
    from ray_tpu_torch.train import gbdt, huggingface, predictor, sklearn
    from ray_tpu_torch.train.rl import RLTrainer

    assert train.RLTrainer is RLTrainer
    assert train._LATER == {}
    assert train.SklearnTrainer is sklearn.SklearnTrainer
    assert train.XGBoostTrainer is gbdt.XGBoostTrainer
    assert train.LightGBMTrainer is gbdt.LightGBMTrainer
    assert train.HuggingFaceTrainer is huggingface.HuggingFaceTrainer
    assert train.HuggingFacePredictor is predictor.HuggingFacePredictor
    assert not hasattr(train, "JaxTrainer")


def test_restart_from_latest_checkpoint_after_worker_death(tmp_path):
    """The loop checkpoints after step 2 and its process dies once
    (``os._exit``, after the trainer has registered the checkpoint);
    ``FailureConfig(max_failures=1)`` restarts the gang, which resumes at
    step 3 from ``session.get_checkpoint()``."""
    marker = tmp_path / "died"

    def loop(config):
        import os
        import time

        resumed = session.get_checkpoint()
        start = resumed.to_dict()["step"] if resumed else 0
        for step in range(start + 1, 5):
            ckpt = Checkpoint.from_dict({"step": step}) if step == 2 else None
            session.report({"step": step, "resumed": bool(resumed)},
                           checkpoint=ckpt)
            if step == 2 and not os.path.exists(config["marker"]):
                registered = os.path.join(config["storage"],
                                          "checkpoint_000001", ".metrics.json")
                deadline = time.time() + 60
                while not os.path.exists(registered) \
                        and time.time() < deadline:
                    time.sleep(0.02)
                open(config["marker"], "w").close()
                os._exit(1)

    result = TorchTrainer(
        loop, train_loop_config={"marker": str(marker),
                                 "storage": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is None, result.error
    assert marker.exists()
    assert [(h["step"], h["resumed"]) for h in result.metrics_history] == [
        (1, False), (2, False), (3, True), (4, True)]
    assert result.checkpoint.to_dict()["step"] == 2


def test_worker_death_beyond_max_failures_gives_up(tmp_path):
    def loop(config):
        import os
        session.report({"step": 1})
        os._exit(1)

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=0)),
    ).fit()
    assert result.error is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pytree_round_trip_is_bitwise(dtype):
    gen = torch.Generator().manual_seed(3)
    tree = {"model": {"w": torch.randn(5, 7, generator=gen).to(dtype),
                      "b": torch.randn(7, generator=gen).to(dtype)},
            "optim": {"state": {0: {"step": torch.tensor(3.0),
                                    "exp_avg": torch.randn(
                                        5, 7, generator=gen)}},
                      "param_groups": [{"lr": 3e-4, "params": [0]}]},
            "view": torch.arange(100000.0).to(dtype)[10:20],
            "step": 4}
    ckpt = Checkpoint.from_pytree(tree, metrics={"loss": 1.5})
    blob = ckpt.to_dict()["pytree_torch"]
    # the view was saved without the rest of its storage
    assert len(blob) < 100000
    target = {"model": {"w": torch.zeros(5, 7, dtype=dtype),
                        "b": torch.zeros(7, dtype=dtype)},
              "optim": {"state": {},  # an optimizer that has not stepped
                        "param_groups": [{"lr": 1.0, "params": [0]}]},
              "view": torch.zeros(10, dtype=dtype), "step": 0}
    got = Checkpoint.from_dict(ckpt.to_dict()).to_pytree(target)
    for name in ("w", "b"):
        assert got["model"][name].dtype == dtype
        assert torch.equal(got["model"][name].view(torch.int8),
                           tree["model"][name].view(torch.int8)), name
    assert torch.equal(got["view"], tree["view"])
    assert torch.equal(got["optim"]["state"][0]["exp_avg"],
                       tree["optim"]["state"][0]["exp_avg"])
    assert got["optim"]["param_groups"][0]["lr"] == 3e-4
    assert got["step"] == 4 and ckpt.metrics == {"loss": 1.5}


def test_to_pytree_raises_on_a_structure_mismatch():
    ckpt = Checkpoint.from_pytree({"w": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="do not match"):
        ckpt.to_pytree({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match=r"\(3,\), target \(4,\)"):
        ckpt.to_pytree({"w": torch.zeros(4), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="entries"):
        Checkpoint.from_pytree([torch.zeros(1)]).to_pytree(
            [torch.zeros(1), torch.zeros(1)])


def test_to_pytree_takes_the_target_dtype():
    ckpt = Checkpoint.from_pytree({"w": torch.tensor([1.5, -2.25])})
    got = ckpt.to_pytree({"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].tolist() == [1.5, -2.25]


def test_pytree_io_saves_and_restores_a_directory(tmp_path):
    from ray_tpu_torch.train.pytree_io import (from_air_checkpoint,
                                               restore_pytree, save_pytree,
                                               to_air_checkpoint)
    tree = {"model": {"w": torch.randn(4, 3)}, "step": 7}
    path = save_pytree(str(tmp_path / "ckpt"), tree)
    raw = restore_pytree(path)
    assert torch.equal(raw["model"]["w"], tree["model"]["w"])
    target = {"model": {"w": torch.zeros(4, 3, dtype=torch.float64)},
              "step": 0}
    got = from_air_checkpoint(to_air_checkpoint(path), target)
    assert got["model"]["w"].dtype == torch.float64 and got["step"] == 7


def _restore_rank(rank, port, root, saved):
    """One gloo rank of the placed restore: saves the plain tree and the
    tree placed Shard(0) (each rank its own directory: the gathered
    value is whole on every rank), restores the plain one onto a
    Shard(0) target and the placed one onto a Replicate() target, and
    writes what came back."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from ray_tpu_torch.train.pytree_io import restore_pytree, save_pytree
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RESTORE_RANKS, rank=rank)
    mesh = init_device_mesh("cpu", (RESTORE_RANKS,))
    plain = {k: torch.from_numpy(v) for k, v in saved.items()}
    placed = {k: distribute_tensor(v, mesh, [Shard(0)])
              for k, v in plain.items()}
    p_plain = save_pytree(os.path.join(root, f"plain{rank}"), plain)
    p_placed = save_pytree(os.path.join(root, f"placed{rank}"), placed)
    out = {}
    for name, path, placement in (("plain_to_shard", p_plain, Shard(0)),
                                  ("shard_to_replicate", p_placed,
                                   Replicate())):
        target = {k: distribute_tensor(torch.zeros_like(v), mesh,
                                       [placement])
                  for k, v in plain.items()}
        got = restore_pytree(path, target)
        out[name] = {k: (isinstance(v, DTensor), str(tuple(v.placements)),
                         v.device_mesh == mesh, v.full_tensor())
                     for k, v in got.items()}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_restore_pytree_lands_on_the_targets_placement(tmp_path):
    """A plain checkpoint restored onto a Shard(0) target and a Shard(0)
    checkpoint onto a Replicate() target, on 4 gloo ranks: every tensor
    comes back a DTensor on the target's mesh and placement, with the
    saved values, which equal the JAX package's ``restore_pytree`` onto
    targets placed P("x") on 4 of the virtual CPU devices."""
    import socket

    import torch.multiprocessing as mp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from ray_tpu.train import orbax as jorbax
    rng = np.random.default_rng(11)
    saved = {"w": rng.standard_normal((8, 6)).astype(np.float32),
             "b": rng.standard_normal((12,)).astype(np.float32)}
    jmesh = Mesh(np.array(jax.devices()[:RESTORE_RANKS]), ("x",))
    jpath = jorbax.save_pytree(str(tmp_path / "jax"), {
        k: jnp.asarray(v) for k, v in saved.items()})
    jtarget = {k: jax.device_put(jnp.zeros_like(v),
                                 NamedSharding(jmesh, P("x")))
               for k, v in saved.items()}
    jgot = jorbax.restore_pytree(jpath, jtarget)
    for k in saved:
        assert jgot[k].sharding == jtarget[k].sharding
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_restore_rank,
                         args=(r, port, str(tmp_path), saved))
             for r in range(RESTORE_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0] * RESTORE_RANKS
    want = {"plain_to_shard": "(Shard(dim=0),)",
            "shard_to_replicate": "(Replicate(),)"}
    for r in range(RESTORE_RANKS):
        out = torch.load(str(tmp_path / f"rank{r}.pt"))
        for case, placements in want.items():
            for k, v in saved.items():
                is_dt, got_place, same_mesh, value = out[case][k]
                assert is_dt and same_mesh and got_place == placements, \
                    (r, case, k, got_place)
                assert torch.equal(value, torch.from_numpy(
                    np.array(jgot[k]))), (r, case, k)


def test_tpus_per_worker_raises():
    with pytest.raises(TypeError, match="gpus_per_worker="):
        ScalingConfig(num_workers=1, tpus_per_worker=1)
    cfg = ScalingConfig(num_workers=2, gpus_per_worker=1)
    assert cfg.worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig().worker_resources() == {"CPU": 1.0}


def test_gpu_worker_sets_its_device_on_the_loop_thread(monkeypatch):
    """A GPU worker makes its leased GPU the current device in setup and
    again on the loop's own thread (the current device belongs to a
    thread), where the loop's CUDA tensors are made."""
    calls = []
    monkeypatch.setattr(rt, "get_gpu_ids", lambda: [3])
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append((d, threading.get_ident())))
    worker = TrainWorker(0, 1)
    assert worker.setup_torch(None, use_gpu=True)
    seen = []
    worker.run(lambda config: seen.append(threading.get_ident()), {})
    worker._thread.join(10)
    assert [d for d, _ in calls] == [3, 3]
    assert calls[1][1] == seen[0] != calls[0][1]
    # lease ids index the visible list: a host that sees four GPUs and
    # leases the third gives every gang member its own card
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    monkeypatch.setattr(rt, "get_gpu_ids", lambda: [2])
    calls.clear()
    worker.setup_torch(None, use_gpu=True)
    assert calls[0][0] == 2


def test_gpu_worker_without_a_lease_raises(monkeypatch):
    monkeypatch.setattr(rt, "get_gpu_ids", lambda: [])
    with pytest.raises(RuntimeError, match="no GPU lease"):
        TrainWorker(0, 1).setup_torch(None, use_gpu=True)


def test_predictor_from_checkpoint_matches_the_model():
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32)
    model = tgpt2.GPT2(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    ckpt = Checkpoint.from_pytree({"model": model.state_dict(), "step": 1})
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 16))
    fresh = tgpt2.GPT2(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    pred = TorchPredictor.from_checkpoint(ckpt, model=fresh, device="cpu")
    out = pred.predict({"data": tokens})["predictions"]
    with torch.no_grad():
        want = model(torch.from_numpy(tokens)).numpy()
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, want)


# --- tiny GPT-2 through the trainer against JAX/optax -----------------------

_STEPS, _BATCH, _SEQ, _CHUNK = 3, 2, 40, 64


def test_tiny_gpt2_through_the_trainer_matches_jax_optax():
    """GPT2Config.tiny in f32, flax weights converted by
    gpt2_state_dict_from_jax, 3 AdamW(3e-4, 0.01) steps on the same
    batches: the losses the trainer's worker reports against the same
    steps in JAX/optax in this process.  f32 on both sides, summation
    order only (measured on the CPU: at most 1e-7 relative)."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    jmodel = jgpt2.GPT2(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0), batch=1, seq=_SEQ)
    params = jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x,
                          params, is_leaf=lambda x: hasattr(x, "unbox"))
    rows = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (_STEPS * _BATCH, _SEQ)).astype(np.int64)
    tx = optax.adamw(3e-4, weight_decay=0.01)
    opt_state, p, jax_losses = tx.init(params), params, []
    for i in range(_STEPS):
        tokens = jnp.asarray(rows[i * _BATCH:(i + 1) * _BATCH], jnp.int32)
        loss, grads = jax.value_and_grad(lambda q: jgpt2.loss_fn(
            jmodel, q, tokens, head_chunk=_CHUNK))(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        jax_losses.append(float(loss))

    def loop(config):  # on the worker; a closure pickles by value
        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train import session

        cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
        model = gpt2.GPT2(cfg, device="cpu")
        model.load_state_dict(session.get_checkpoint().to_pytree(
            {"model": model.state_dict()})["model"])
        opt = gpt2.adamw(model.parameters(), lr=3e-4, weight_decay=0.01)
        shard = session.get_dataset_shard("train")
        for batch in shard.to_torch(batch_size=config["batch"],
                                    device="cpu"):
            loss = gpt2.train_step(model, opt, batch["data"],
                                   head_chunk=config["chunk"])
            session.report({"loss": loss.item()})

    state = gpt2_state_dict_from_jax(jax.tree.map(np.asarray, params))
    batches = [rows[i * _BATCH:(i + 1) * _BATCH] for i in range(_STEPS)]
    result = TorchTrainer(
        loop, train_loop_config={"batch": _BATCH, "chunk": _CHUNK},
        scaling_config=ScalingConfig(num_workers=1),
        datasets={"train": rdata.from_numpy(batches)},
        resume_from_checkpoint=Checkpoint.from_pytree({"model": state}),
    ).fit()
    assert result.error is None, result.error
    losses = [h["loss"] for h in result.metrics_history]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)


def test_predictor_defaults_to_cuda():
    model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu")
    if torch.cuda.is_available():
        assert TorchPredictor(model)._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchPredictor(model)
