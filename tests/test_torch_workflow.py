"""The port's durable workflows (``ray_tpu_torch.workflow``) on the CPU:
counterparts of tests/test_workflow.py's cases on one cluster for the
module, each with the values the JAX package's case pins; both packages'
``_assign_step_ids`` on the same DAG shapes; a tiny GPT-2 forward as a
workflow step in both packages on the same weights (the JAX side in a
subprocess, as the two packages' clusters never share a process); and
tensor outputs that reload bit for bit in a fresh driver after a
resume."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import workflow as jworkflow
from ray_tpu.workflow import workflow as jworkflow_mod
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.workflow import workflow as workflow_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SEQ = 16


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), **extra)


# The JAX package's side of test_tiny_gpt2_step_matches_jax: GPT-2
# tiny's flax init (PRNGKey 0) and its f32 forward on seeded tokens as a
# workflow step, in a process of its own, started with the module.
_JAX_GPT2 = textwrap.dedent(f"""
    import os, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    import ray_tpu
    from ray_tpu import workflow
    from ray_tpu.models import gpt2

    out_dir = sys.argv[1]
    cfg = gpt2.GPT2Config.tiny(dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, {_SEQ}), dtype=np.int32)
    params = jax.tree.map(
        lambda x: np.asarray(x.unbox() if hasattr(x, "unbox") else x),
        gpt2.GPT2(cfg).init_params(jax.random.PRNGKey(0), seq={_SEQ}),
        is_leaf=lambda x: hasattr(x, "unbox"))

    @ray_tpu.remote
    def forward(params, tokens):
        import jax.numpy as jnp
        from ray_tpu.models import gpt2
        model = gpt2.GPT2(gpt2.GPT2Config.tiny(dtype=jnp.float32))
        return np.asarray(model.apply({{"params": params}}, tokens))

    ray_tpu.init(num_cpus=2, object_store_memory=128 * 2**20)
    workflow.init(os.path.join(out_dir, "wf"))
    logits = workflow.run(forward.bind(params, tokens), workflow_id="gpt2")
    status = workflow.get_status("gpt2")
    ray_tpu.shutdown()
    flat = {{"/".join(str(getattr(k, "key", k)) for k in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}}
    np.savez(os.path.join(out_dir, "jax_gpt2.npz"), logits=logits,
             tokens=tokens, **{{"p:" + k: v for k, v in flat.items()}})
    print("STATUS " + status, flush=True)
""")


@pytest.fixture(scope="module")
def jax_gpt2(tmp_path_factory):
    """The JAX side's subprocess, started with the module so that it
    runs beside the port's cases."""
    out = tmp_path_factory.mktemp("jax_gpt2")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_GPT2, str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=REPO)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def cluster(jax_gpt2):
    rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


@pytest.fixture(autouse=True)
def wf_storage(tmp_path):
    workflow.init(str(tmp_path / "wf"))
    yield


@rt.remote
def double(x):
    return x * 2


@rt.remote
def add(a, b):
    return a + b


def test_run_and_output():
    with InputNode() as inp:
        dag = add.bind(double.bind(inp), 1)
    assert workflow.run(dag, 5, workflow_id="w1") == 11
    assert workflow.get_status("w1") == workflow.SUCCEEDED
    assert workflow.get_output("w1") == 11
    rows = workflow.list_all()
    assert any(r["workflow_id"] == "w1" for r in rows)


def test_resume_skips_completed_steps(tmp_path):
    count, ok = str(tmp_path / "count"), str(tmp_path / "flaky_ok")

    @rt.remote
    def count_calls(x):
        with open(count, "a") as f:  # steps run in other processes
            f.write("x")
        return x + 1

    @rt.remote
    def flaky(x):
        if not os.path.exists(ok):
            raise RuntimeError("first attempt fails")
        return x * 10

    dag = flaky.bind(count_calls.bind(3))
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w2")
    assert workflow.get_status("w2") == workflow.RESUMABLE
    assert os.path.getsize(count) == 1
    open(ok, "w").close()
    assert workflow.resume("w2") == 40
    # resume did NOT re-run the completed first step
    assert os.path.getsize(count) == 1
    assert workflow.get_status("w2") == workflow.SUCCEEDED


def test_diamond_runs_once_and_persists():
    with InputNode() as inp:
        shared = double.bind(inp)
        dag = add.bind(shared, shared)
    assert workflow.run(dag, 4, workflow_id="w3") == 16
    storage = workflow.WorkflowStorage("w3")
    assert storage.has_step("0001_double")
    assert storage.has_step("0002_add")


def test_delete():
    workflow.run(double.bind(1), workflow_id="w4")
    workflow.delete("w4")
    assert workflow.get_status("w4") is None


def test_workflow_event_step():
    """A workflow pauses at wait_for_event until send_event delivers,
    and a resumed run sees the SAME payload (exactly-once)."""
    @rt.remote
    def process(evt, base):
        return f"{base}:{evt['user']}"

    dag = process.bind(workflow.wait_for_event("approval"), "order7")
    wid = "evt_flow"

    def deliver():
        time.sleep(0.8)
        workflow.send_event(wid, "approval", {"user": "alice"})

    t = threading.Thread(target=deliver)
    t.start()
    out = workflow.run(dag, workflow_id=wid)
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == "order7:alice"
    assert workflow.resume(wid) == "order7:alice"


def test_workflow_event_timeout():
    @rt.remote
    def consume(evt):
        return evt

    dag = consume.bind(workflow.wait_for_event("never", timeout=0.5))
    with pytest.raises(TimeoutError, match="never"):
        workflow.run(dag, workflow_id="evt_timeout")


def test_step_max_retries(tmp_path):
    marker = tmp_path / "attempts"

    @rt.remote
    def flaky():
        n = int(marker.read_text()) if marker.exists() else 0
        marker.write_text(str(n + 1))
        if n < 2:
            raise RuntimeError("transient")
        return "ok"

    dag = workflow.options(flaky.bind(), max_retries=3)
    assert workflow.run(dag, workflow_id="w_retry") == "ok"
    assert int(marker.read_text()) == 3  # 2 failures + 1 success


def test_step_catch_exceptions():
    @rt.remote
    def boom():
        raise ValueError("nope")

    dag = workflow.options(boom.bind(), catch_exceptions=True)
    value, err = workflow.run(dag, workflow_id="w_catch")
    assert value is None
    assert "nope" in str(err)
    assert workflow.get_status("w_catch") == workflow.SUCCEEDED


def test_dynamic_continuation():
    @rt.remote
    def fib_cont(n):
        if n <= 1:
            return n
        return workflow.continuation(
            add.bind(fib_cont.bind(n - 1), fib_cont.bind(n - 2)))

    assert workflow.run(fib_cont.bind(7), workflow_id="w_fib") == 13
    storage = workflow.WorkflowStorage("w_fib")
    nested = [d for d, _, files in os.walk(storage.dir) if files]
    assert len(nested) > 1


def test_management_actor_status():
    with InputNode() as inp:
        dag = double.bind(inp)
    workflow.run(dag, 4, workflow_id="w_mgmt")
    actor = rt.get_actor(workflow_mod.MANAGEMENT_ACTOR_NAME)
    listing = rt.get(actor.list_status.remote(), timeout=30)
    assert listing.get("w_mgmt", {}).get("status") == workflow.SUCCEEDED


def test_default_root_is_the_ports_own(monkeypatch, tmp_path):
    """Neither runtime reads the other's pickles: the default storage
    roots differ."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(workflow_mod, "_storage_dir", None)
    monkeypatch.setattr(jworkflow_mod, "_storage_dir", None)
    workflow.init()
    jworkflow.init()
    assert workflow_mod._root() == str(tmp_path / ".ray_tpu_torch_workflows")
    assert jworkflow_mod._root() != workflow_mod._root()


_CRASH_SCRIPT = """
import os, sys, threading, time
import ray_tpu_torch as rt
from ray_tpu_torch import workflow

rt.init(num_cpus=2)
workflow.init({store!r})
COUNTS = {counts!r}

@rt.remote
def step_a():
    open(COUNTS + "/a", "a").write("x")
    return 1

@rt.remote
def step_b(x):
    open(COUNTS + "/b", "a").write("x")
    if os.environ.get("WF_CRASH"):
        time.sleep(60)  # hold the step so the driver dies mid-step
    return x + 1

@rt.remote
def step_c(x):
    open(COUNTS + "/c", "a").write("x")
    return x + 1

if os.environ.get("WF_CRASH"):
    # SIGKILL-equivalent: hard-exit the driver once step_b is running,
    # BEFORE its output is persisted (persistence is driver-side)
    def _killer():
        while not os.path.exists(COUNTS + "/b"):
            time.sleep(0.01)
        os._exit(9)
    threading.Thread(target=_killer, daemon=True).start()
    dag = step_c.bind(step_b.bind(step_a.bind()))
    print(workflow.run(dag, workflow_id="w_crash"))
else:
    print(workflow.resume("w_crash"))
"""


def test_crash_recovery_each_step_once(tmp_path):
    """kill -9 the driver mid-workflow; resume() completes with each
    completed step having executed exactly once: the JAX package's case
    pins step_a 1, step_b 2 (it crashed before its output was on disk),
    step_c 1."""
    counts = tmp_path / "counts"
    counts.mkdir()
    script = _CRASH_SCRIPT.format(store=str(tmp_path / "wfstore"),
                                  counts=str(counts))
    p = subprocess.run([sys.executable, "-c", script],
                       env=_env(WF_CRASH="1"), capture_output=True,
                       text=True, timeout=180, cwd=REPO)
    assert p.returncode == 9, (p.returncode, p.stderr[-2000:])
    p = subprocess.run([sys.executable, "-c", script], env=_env(),
                       capture_output=True, text=True, timeout=180, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().endswith("3")
    assert {n: len((counts / n).read_text()) for n in "abc"} == \
        {"a": 1, "b": 2, "c": 1}


def _dag_shapes(pkg, dag_mod):
    """The same DAG shapes built with one package's remote functions and
    actor class: a chain, a diamond, an input node with its attributes,
    nested containers of nodes, and an actor method chain."""
    @pkg.remote
    def f(*args, **kwargs):
        return 0

    @pkg.remote
    def g(*args, **kwargs):
        return 0

    @pkg.remote
    class Counter:
        def bump(self, x):
            return x

    shapes = {}
    shapes["chain"] = g.bind(f.bind(f.bind(1)))
    shared = f.bind(2)
    shapes["diamond"] = g.bind(shared, g.bind(shared), k=shared)
    with dag_mod.InputNode() as inp:
        shapes["input"] = g.bind(f.bind(inp["a"]), f.bind(inp.b), inp)
    shapes["nested"] = g.bind([f.bind(1), (f.bind(2), {"x": g.bind(3)})])
    counter = Counter.bind()
    shapes["actor"] = g.bind(counter.bump.bind(counter.bump.bind(f.bind(5))))
    return shapes


def test_step_ids_match_jax():
    """Both packages' ``_assign_step_ids`` number the same DAG shapes
    the same way (positional DFS ids: what resume's correctness needs)."""
    from ray_tpu import dag as jdag
    from ray_tpu_torch import dag as tdag
    jshapes = _dag_shapes(ray_tpu, jdag)
    tshapes = _dag_shapes(rt, tdag)
    for name in jshapes:
        want = sorted(jworkflow_mod._assign_step_ids(jshapes[name]).values())
        got = sorted(workflow_mod._assign_step_ids(tshapes[name]).values())
        assert got == want, name
        assert got, name


def test_tiny_gpt2_step_matches_jax(jax_gpt2, tmp_path):
    """GPT-2 tiny (2 layers, width 64, f32 compute) as a workflow step
    in both packages on the same weights (the flax init, converted) and
    tokens: logits within test_torch_gpt2.py's f32 tolerance; both
    SUCCEEDED."""
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax
    proc, out_dir = jax_gpt2
    stdout, stderr = proc.communicate(timeout=240)
    assert proc.returncode == 0, stderr[-3000:]
    assert "STATUS SUCCEEDED" in stdout, stdout
    saved = np.load(out_dir / "jax_gpt2.npz")
    params = {}
    for key in saved.files:
        if key.startswith("p:"):
            node = params
            *path, leaf = key[2:].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = saved[key]
    state = gpt2_state_dict_from_jax(params)

    @rt.remote
    def forward(state, tokens):
        model = tgpt2.GPT2(tgpt2.GPT2Config.tiny(dtype=torch.float32),
                           device="cpu")
        model.load_state_dict(state)
        with torch.no_grad():
            return model(tokens)

    tokens = torch.from_numpy(saved["tokens"])
    logits = workflow.run(forward.bind(state, tokens), workflow_id="gpt2")
    assert workflow.get_status("gpt2") == workflow.SUCCEEDED
    np.testing.assert_allclose(logits.numpy(), saved["logits"],
                               atol=1e-4, rtol=1e-4)
    # the durable output is the same tensor
    assert torch.equal(workflow.get_output("gpt2"), logits)


_TENSOR_SCRIPT = """
import json, os, sys
import torch
import ray_tpu_torch as rt
from ray_tpu_torch import workflow

rt.init(num_cpus=2)
workflow.init({store!r})
OK = {ok!r}

@rt.remote
def make():
    gen = torch.Generator().manual_seed(7)
    return {{"bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
             "f32": torch.randn(4, 2, generator=gen)}}

@rt.remote
def check(tensors):
    if not os.path.exists(OK):
        raise RuntimeError("first attempt fails")
    return tensors

if sys.argv[1] == "run":
    try:
        workflow.run(check.bind(make.bind()), workflow_id="tensors")
    except Exception:
        print("STATUS " + workflow.get_status("tensors"))
else:
    out = workflow.resume("tensors")
    print("STATUS " + workflow.get_status("tensors"))
    print("OUT " + json.dumps({{k: [str(v.dtype), v.float().tolist()]
                                for k, v in out.items()}}))
rt.shutdown()
"""


def test_tensor_outputs_reload_bitwise_in_a_fresh_driver(tmp_path):
    """A step's bf16 and f32 CPU tensors, stored by one driver, reload in
    a fresh driver after a resume equal bit for bit, and in this
    process too, by the store's tensor rule."""
    store, ok = str(tmp_path / "store"), str(tmp_path / "ok")
    script = _TENSOR_SCRIPT.format(store=store, ok=ok)
    first = subprocess.run([sys.executable, "-c", script, "run"],
                           env=_env(), capture_output=True, text=True,
                           timeout=180, cwd=REPO)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "STATUS RESUMABLE" in first.stdout, first.stdout
    open(ok, "w").close()
    second = subprocess.run([sys.executable, "-c", script, "resume"],
                            env=_env(), capture_output=True, text=True,
                            timeout=180, cwd=REPO)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "STATUS SUCCEEDED" in second.stdout, second.stdout
    got = json.loads([ln for ln in second.stdout.splitlines()
                      if ln.startswith("OUT ")][-1][4:])
    gen = torch.Generator().manual_seed(7)
    want = {"bf16": torch.randn(3, 5, generator=gen).to(torch.bfloat16),
            "f32": torch.randn(4, 2, generator=gen)}
    for name, t in want.items():
        assert got[name][0] == str(t.dtype)
        assert torch.equal(torch.tensor(got[name][1]).to(t.dtype), t), name
    workflow.init(store)
    stored = workflow.WorkflowStorage("tensors").load_step("0000_make")
    assert {k: v.dtype for k, v in stored.items()} == \
        {k: v.dtype for k, v in want.items()}
    for name, t in want.items():
        assert torch.equal(stored[name], t), name
    assert torch.equal(workflow.get_output("tensors")["bf16"], want["bf16"])
