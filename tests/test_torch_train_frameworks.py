"""The port's framework trainers on the CPU against the JAX package's:
``SklearnTrainer`` (scores and ``BatchPredictor`` predictions), the
GBDT trainers' gate, ``HuggingFacePredictor`` on one saved DistilBERT,
and ``HuggingFaceTrainer`` against the same ``transformers.Trainer``
run directly.  One port cluster for the file; the JAX package's
cluster runs in a subprocess (the two never share a process)."""

import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.train import checkpoint as jckpt
from ray_tpu.train import gbdt as jgbdt
from ray_tpu.train import predictor as jpred
from ray_tpu_torch import data as rdata
from ray_tpu_torch.train import (
    BatchPredictor,
    Checkpoint,
    HuggingFacePredictor,
    HuggingFaceTrainer,
    LightGBMTrainer,
    ScalingConfig,
    SklearnPredictor,
    SklearnTrainer,
    XGBoostTrainer,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    yield
    rt.shutdown()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, as the other
    parity modules do under the suite's ``-n 6``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the same case through either package: its data module, trainer and
# predictors come in as arguments
_SKLEARN_CASE = '''
def run(rdata, SklearnTrainer, BatchPredictor, SklearnPredictor):
    import numpy as np
    from sklearn.linear_model import Ridge

    rng = np.random.default_rng(0)
    x = rng.random((200, 3))
    y = x @ np.array([3.0, -2.0, 0.5]) + 0.1 * rng.standard_normal(200)
    ds = rdata.from_numpy(np.column_stack([x, y])).map_batches(
        lambda b: {"x1": b["data"][:, 0], "x2": b["data"][:, 1],
                   "x3": b["data"][:, 2], "y": b["data"][:, 3]},
        batch_format="numpy")
    result = SklearnTrainer(estimator=Ridge(alpha=0.3),
                            datasets={"train": ds, "valid": ds},
                            label_column="y").fit()
    rows = BatchPredictor.from_checkpoint(
        result.checkpoint, SklearnPredictor).predict(
            ds.limit(50), batch_size=25).take_all()
    return {"metrics": result.metrics,
            "predictions": [float(r["predictions"]) for r in rows]}
'''


@pytest.fixture(scope="module", autouse=True)
def jax_sklearn():
    """The case through the JAX package, in a subprocess started with
    the module (its cluster and scikit-learn's import take most of its
    time) and read by the last test."""
    code = (
        "import json, os, sys\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import ray_tpu\n"
        "from ray_tpu import data\n"
        "from ray_tpu.train.predictor import BatchPredictor, "
        "SklearnPredictor\n"
        "from ray_tpu.train.sklearn import SklearnTrainer\n"
        + _SKLEARN_CASE +
        "ray_tpu.init(num_cpus=2, object_store_memory=128 * 2**20)\n"
        "try:\n"
        "    out = run(data, SklearnTrainer, BatchPredictor, "
        "SklearnPredictor)\n"
        "finally:\n"
        "    ray_tpu.shutdown()\n"
        "print('RESULT' + json.dumps(out))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    proc.kill()
    proc.communicate()


def test_gbdt_trainers_gate_on_missing_libs():
    ds = rdata.from_items([{"x": float(i), "y": float(i % 2)}
                           for i in range(8)])
    for cls, jcls, mod in ((XGBoostTrainer, jgbdt.XGBoostTrainer, "xgboost"),
                           (LightGBMTrainer, jgbdt.LightGBMTrainer,
                            "lightgbm")):
        if importlib.util.find_spec(mod) is not None:
            result = cls(params={}, datasets={"train": ds},
                         label_column="y", num_boost_round=2).fit()
            assert result.checkpoint is not None
            continue
        with pytest.raises(ImportError, match=mod) as got:
            cls(params={}, datasets={"train": ds}, label_column="y")
        with pytest.raises(ImportError, match=mod) as want:
            jcls(params={}, datasets={"train": None}, label_column="y")
        assert str(got.value).replace("ray_tpu_torch", "ray_tpu") == \
            str(want.value)


def _tiny_distilbert(seed=0, seq=8):
    import transformers

    torch.manual_seed(seed)
    config = transformers.DistilBertConfig(
        vocab_size=50, dim=16, n_layers=1, n_heads=2, hidden_dim=32,
        max_position_embeddings=seq, num_labels=2)
    return transformers.DistilBertForSequenceClassification(config)


def test_huggingface_predictor_matches_the_jax_package(tmp_path):
    """Both packages' predictor on one saved DistilBERT: equal logits
    (the port's with device="cpu"); the port's default needs CUDA."""
    import transformers

    _tiny_distilbert().save_pretrained(str(tmp_path / "m"))
    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, 50, (3, 8)),
             "attention_mask": np.ones((3, 8), np.int64)}
    cls = transformers.DistilBertForSequenceClassification
    want = jpred.HuggingFacePredictor.from_checkpoint(
        jckpt.Checkpoint.from_directory(str(tmp_path / "m")),
        model_cls=cls).predict(batch)["predictions"]
    pred = HuggingFacePredictor.from_checkpoint(
        Checkpoint.from_directory(str(tmp_path / "m")), model_cls=cls,
        device="cpu")
    got = pred.predict(batch)["predictions"]
    assert got.shape == (3, 2)
    np.testing.assert_array_equal(got, want)
    if torch.cuda.is_available():
        assert HuggingFacePredictor(_tiny_distilbert())._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HuggingFacePredictor.from_checkpoint(
                Checkpoint.from_directory(str(tmp_path / "m")),
                model_cls=cls)


def _hf_trainer_init(out_dir):
    """The trainer_init_per_worker of the HF case, made in a function so
    that it pickles by value: the smallest DistilBERT that trains, on
    the CPU, one intra-op thread on either side."""
    def trainer_init(train_dataset, eval_dataset, **config):
        import torch
        import transformers

        torch.set_num_threads(1)
        torch.manual_seed(0)
        model = transformers.DistilBertForSequenceClassification(
            transformers.DistilBertConfig(
                vocab_size=50, dim=16, n_layers=1, n_heads=2, hidden_dim=32,
                max_position_embeddings=8, num_labels=2))
        args = transformers.TrainingArguments(
            output_dir=out_dir, num_train_epochs=1,
            per_device_train_batch_size=8, logging_steps=1, report_to=[],
            disable_tqdm=True, save_strategy="no", use_cpu=True)
        return transformers.Trainer(model=model, args=args,
                                    train_dataset=train_dataset)
    return trainer_init


def test_huggingface_trainer_matches_a_direct_run(tmp_path):
    """HuggingFaceTrainer's worker against the same transformers.Trainer
    run in this process: equal logged losses; the checkpoint loads with
    from_pretrained and predicts as the direct model does."""
    import datasets as hf_datasets
    import transformers

    rng = np.random.default_rng(0)
    n, seq = 32, 8
    train_ds = hf_datasets.Dataset.from_dict({
        "input_ids": rng.integers(0, 50, (n, seq)).tolist(),
        "attention_mask": np.ones((n, seq), np.int64).tolist(),
        "labels": rng.integers(0, 2, n).tolist(),
    })
    direct = _hf_trainer_init(str(tmp_path / "direct"))(train_ds, None)
    direct.train()
    want = [h["loss"] for h in direct.state.log_history if "loss" in h]

    result = HuggingFaceTrainer(
        trainer_init_per_worker=_hf_trainer_init(str(tmp_path / "worker")),
        scaling_config=ScalingConfig(num_workers=1, cpus_per_worker=1),
        datasets={"train": train_ds}).fit()
    assert result.error is None, result.error
    got = [m["loss"] for m in result.metrics_history if "loss" in m]
    assert len(want) == n // 8
    assert got == want
    batch = {"input_ids": rng.integers(0, 50, (2, seq)),
             "attention_mask": np.ones((2, seq), np.int64)}
    pred = HuggingFacePredictor.from_checkpoint(
        result.checkpoint,
        model_cls=transformers.DistilBertForSequenceClassification,
        device="cpu")
    with torch.no_grad():
        direct_logits = direct.model.eval()(
            **{k: torch.as_tensor(v) for k, v in batch.items()}).logits
    np.testing.assert_array_equal(pred.predict(batch)["predictions"],
                                  direct_logits.numpy())


def test_sklearn_trainer_matches_the_jax_package(jax_sklearn):
    """The same rows and estimator through both packages' trainer and
    BatchPredictor: equal train and valid scores, equal predictions (the
    fit runs on the host in both)."""
    namespace = {}
    exec(_SKLEARN_CASE, namespace)
    got = namespace["run"](rdata, SklearnTrainer, BatchPredictor,
                           SklearnPredictor)
    proc = jax_sklearn
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT"))
    want = json.loads(line[len("RESULT"):])
    assert got == want
    assert got["metrics"]["train_score"] > 0.99
    assert len(got["predictions"]) == 50
