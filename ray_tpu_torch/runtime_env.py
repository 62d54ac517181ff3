"""Per-task/actor runtime environments.

Parity: reference ``python/ray/_private/runtime_env/`` — the
``runtime_env={"env_vars", "working_dir", "py_modules"}`` option on
``@remote`` functions/actors, with content-addressed packaging
(``packaging.py`` URI cache): the driver zips ``working_dir`` /
``py_modules`` into the GCS KV keyed by content hash, and each worker
extracts once into a per-host cache before applying.

``pip`` envs (reference ``runtime_env/pip.py``) build once into a
content-addressed ``pip install --target`` directory and are applied by
prepending that directory to ``sys.path`` of a *dedicated* worker —
workers are keyed by env hash (the raylet's WorkerPool routes other
envs to other workers), so the injection never leaks across envs.  This
is the TPU-deployment equivalent of the reference's per-env venv
interpreter: same isolation contract, no interpreter respawn.  By
default installs consult the configured index; air-gapped deployments
pass ``pip_install_options`` (e.g. ``--no-index --find-links …``).

Isolated-interpreter envs (reference ``runtime_env/{conda,container}.py``
and the ``py_executable`` field): ``pip`` with ``isolation: "venv"``
builds a content-addressed virtualenv and the raylet launches the
dedicated worker from the venv's interpreter — full interpreter
isolation, so package versions that conflict with the base image work;
``conda`` activates/creates a conda env (gated on a conda binary —
``RAY_TPU_TORCH_CONDA_BIN`` overrides discovery); ``container`` wraps the
worker launch in a container runtime (podman/docker, host network + IPC
so the worker reaches the raylet and the shm object store;
``RAY_TPU_TORCH_CONTAINER_BIN`` overrides discovery); ``py_executable`` uses
an explicit interpreter as-is.  The raylet resolves these at spawn time
(``spawn_spec`` travels with the lease request) and builds envs off the
io loop.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import re
import shutil
import sys
import tempfile
import fnmatch
import zipfile
from typing import Any, Dict, List, Optional

_CACHE_ROOT = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                           "ray_tpu_torch_runtime_env_cache")

SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip", "conda",
             "excludes",
             "container", "py_executable"}


def conda_binary() -> Optional[str]:
    """The conda executable, or None when this deployment has none."""
    override = os.environ.get("RAY_TPU_TORCH_CONDA_BIN")
    if override:
        return override
    return shutil.which("conda") or shutil.which("mamba") \
        or shutil.which("micromamba")


def container_binary() -> Optional[str]:
    """The container runtime, or None when this deployment has none."""
    override = os.environ.get("RAY_TPU_TORCH_CONTAINER_BIN")
    if override:
        return override
    return shutil.which("podman") or shutil.which("docker")


def validate(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if not runtime_env:
        return {}
    unknown = set(runtime_env) - SUPPORTED
    if unknown:
        raise ValueError(f"unknown runtime_env keys {sorted(unknown)} "
                         f"(supported: {sorted(SUPPORTED)})")
    out = dict(runtime_env)
    if "excludes" in out:
        if not isinstance(out["excludes"], (list, tuple)) or not all(
                isinstance(x, str) for x in out["excludes"]):
            raise ValueError("runtime_env['excludes'] must be a list of "
                             "path patterns")
        if "working_dir" not in out:
            raise ValueError("runtime_env['excludes'] requires "
                             "'working_dir'")
        if str(out["working_dir"]).startswith("kv://"):
            raise ValueError(
                "runtime_env['excludes'] cannot apply to an already-"
                "packaged kv:// working_dir — the zip is final")
    if "pip" in out:
        out["pip"] = _normalize_pip(out["pip"])
    if "conda" in out:
        # only shape-check here: the conda binary is needed on the
        # WORKER host at spawn time, which may not be this driver host
        if not isinstance(out["conda"], (str, dict)):
            raise ValueError("runtime_env['conda'] must be an env name "
                             "or an environment.yml-style dict")
    if "container" in out:
        spec = out["container"]
        if not isinstance(spec, dict) or not spec.get("image"):
            raise ValueError("runtime_env['container'] must be a dict "
                             "with an 'image'")
    if "py_executable" in out and not isinstance(out["py_executable"],
                                                 str):
        raise ValueError("runtime_env['py_executable'] must be a path")
    return out


def _normalize_pip(spec: Any) -> Dict[str, Any]:
    """Accept ``["six"]`` or ``{"packages": [...],
    "pip_install_options": [...], "isolation": "venv"|"path"}``
    (reference pip field shapes; ``isolation`` picks sys.path injection
    — the default, no interpreter respawn — or a dedicated venv
    interpreter)."""
    if isinstance(spec, (list, tuple)):
        return {"packages": [str(p) for p in spec],
                "pip_install_options": [], "isolation": "path"}
    if isinstance(spec, dict):
        isolation = str(spec.get("isolation", "path"))
        if isolation not in ("path", "venv"):
            raise ValueError("pip isolation must be 'path' or 'venv'")
        return {"packages": [str(p) for p in spec.get("packages", [])],
                "pip_install_options": [
                    str(o) for o in spec.get("pip_install_options", [])],
                "isolation": isolation}
    raise ValueError(f"runtime_env['pip'] must be a list or dict, got "
                     f"{type(spec).__name__}")


def spawn_spec(runtime_env: Optional[Dict[str, Any]]
               ) -> Optional[Dict[str, Any]]:
    """The part of an env the *raylet* must resolve before spawning the
    dedicated worker (an interpreter/command substitution).  None means
    the env applies in-process on any pool worker."""
    if not runtime_env:
        return None
    out: Dict[str, Any] = {}
    if runtime_env.get("py_executable"):
        out["py_executable"] = str(runtime_env["py_executable"])
    if runtime_env.get("conda"):
        out["conda"] = runtime_env["conda"]
    if runtime_env.get("container"):
        out["container"] = runtime_env["container"]
    pip = runtime_env.get("pip")
    if pip and pip.get("isolation") == "venv":
        out["pip_venv"] = pip
    return out or None


def env_hash(runtime_env: Dict[str, Any]) -> str:
    """Stable identity for worker dedication + caching."""
    return hashlib.sha256(
        json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=1024)
def _exclude_regex(core: str) -> "re.Pattern":
    """Translate one gitwildmatch-style pattern into a relpath regex.

    Unlike ``fnmatch`` (whose ``*`` crosses ``/``), ``*`` and ``?``
    stop at path-segment boundaries and only ``**`` spans directories —
    the reference's gitwildmatch semantics, so ``data/*.bin`` excludes
    ``data/x.bin`` but NOT ``data/sub/x.bin``.  The compiled regex also
    matches the pattern as a directory prefix (``dir`` excludes
    ``dir/anything``)."""
    out = []
    i, n = 0, len(core)
    while i < n:
        c = core[i]
        if c == "*":
            if core.startswith("**/", i):
                out.append("(?:[^/]+/)*")  # zero or more whole segments
                i += 3
            elif core.startswith("**", i):
                out.append(".*")
                i += 2
            else:
                out.append("[^/]*")
                i += 1
        elif c == "?":
            out.append("[^/]")
            i += 1
        elif c == "[":
            j = core.find("]", i + 1)
            if j == -1:
                out.append(re.escape(c))
                i += 1
            else:
                cls = core[i + 1:j]
                if cls.startswith("!"):
                    # gitwildmatch negation; never matches a separator
                    cls = "^/" + cls[1:]
                out.append("[" + cls + "]")
                i = j + 1
        else:
            out.append(re.escape(c))
            i += 1
    try:
        return re.compile("".join(out) + r"(?:/.*)?\Z")
    except re.error:
        # degenerate class (e.g. "[]]"): fall back to a literal match
        # rather than crashing working_dir packaging
        return re.compile(re.escape(core) + r"(?:/.*)?\Z")


def _excluded(rel: str, patterns) -> bool:
    """Gitwildmatch-style exclude check against the POSIX relpath
    (reference packaging.py semantics; covers the common forms:
    "*.ext", "dir/*.ext", "dir/**", "dir/", "name", "/anchored")."""
    rel = rel.replace(os.sep, "/")
    for pat in patterns:
        pat = pat.replace(os.sep, "/")
        anchored = pat.startswith("/")
        core = pat.lstrip("/").rstrip("/")
        if not core:
            continue
        if _exclude_regex(core).match(rel):
            return True
        if not anchored and "/" not in core:
            # bare name: floats to any depth — matches the basename or
            # any directory segment (segments contain no "/", so plain
            # fnmatch is exact here)
            if fnmatch.fnmatch(os.path.basename(rel), core) \
                    or any(fnmatch.fnmatch(part, core)
                           for part in rel.split("/")[:-1]):
                return True
    return False


def _walk_files(path: str, excludes=None):
    out = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        if excludes:
            # prune excluded trees so packaging cost doesn't scale with
            # the directories the user asked to skip
            dirs[:] = [d for d in dirs if not _excluded(
                os.path.relpath(os.path.join(root, d), path), excludes)]
        if "__pycache__" in root:
            continue
        for name in sorted(files):
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            if excludes and _excluded(rel, excludes):
                continue
            out.append((rel, full))
    return out


def _content_digest(entries) -> str:
    """Digest of (relpath, file bytes) pairs — stable across mtimes and
    filesystem walk order, unlike hashing the zip bytes."""
    h = hashlib.sha256()
    for rel, full in entries:
        h.update(rel.encode())
        with open(full, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _zip_entries(entries, arc_prefix: str = "") -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in entries:
            zf.write(full, os.path.join(arc_prefix, rel))
    return buf.getvalue()


# packaged form cached per env content so repeated .remote() calls (e.g.
# an actor class instantiated in a loop) zip + upload once
_package_cache: Dict[str, Dict[str, Any]] = {}


def package(runtime_env: Dict[str, Any], kv_put) -> Dict[str, Any]:
    """Driver side: replace local dirs with content-addressed URIs
    (reference ``upload_package_if_needed``)."""
    cache_key = env_hash(runtime_env)
    hit = _package_cache.get(cache_key)
    if hit is not None:
        return hit
    out = dict(runtime_env)
    if "working_dir" in out and not str(out["working_dir"]).startswith(
            "kv://"):
        entries = _walk_files(out["working_dir"], out.get("excludes"))
        digest = _content_digest(entries)
        kv_put(f"pkg:{digest}", _zip_entries(entries), "_runtime_env")
        out["working_dir"] = f"kv://{digest}"
    # excludes is a driver-side packaging directive only; workers never
    # need it (the zip already omits the files)
    out.pop("excludes", None)
    if "py_modules" in out:
        uris: List[str] = []
        for mod in out["py_modules"]:
            if str(mod).startswith("kv://"):
                uris.append(mod)
                continue
            # a module dir is zipped with its top-level name preserved so
            # the extraction root can go on sys.path
            base = os.path.basename(os.path.abspath(mod))
            entries = _walk_files(mod)
            digest = _content_digest([(os.path.join(base, r), f)
                                      for r, f in entries])
            kv_put(f"pkg:{digest}", _zip_entries(entries, base),
                   "_runtime_env")
            uris.append(f"kv://{digest}")
        out["py_modules"] = uris
    _package_cache[cache_key] = out
    return out


def _extract(uri: str, kv_get) -> str:
    digest = uri[len("kv://"):]
    dest = os.path.join(_CACHE_ROOT, digest)
    if not os.path.isdir(dest):
        blob = kv_get(f"pkg:{digest}", "_runtime_env")
        if blob is None:
            raise RuntimeError(f"runtime env package {uri} missing from KV")
        # extract to a private temp dir, then atomically rename into
        # place: concurrent workers never observe half-written files
        os.makedirs(_CACHE_ROOT, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{digest}-", dir=_CACHE_ROOT)
        try:
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            os.rename(tmp, dest)
        except OSError:
            # another worker won the rename race
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.isdir(dest):
                raise
    return dest


def _ensure_pip_env(pip_spec: Dict[str, Any]) -> str:
    """Build (once, content-addressed) a ``pip install --target`` dir for
    the given package set; returns the directory to put on sys.path.

    Concurrency: an exclusive flock around the build plus an atomic
    rename-into-place, so parallel workers race safely and losers reuse
    the winner's build (reference ``pip.py`` builds under a per-URI
    lock the same way).
    """
    import subprocess

    packages = pip_spec.get("packages", [])
    opts = pip_spec.get("pip_install_options", [])
    if not packages:
        raise ValueError("runtime_env['pip'] has no packages")
    digest = hashlib.sha256(
        json.dumps([packages, opts, sys.version_info[:2]],
                   sort_keys=True).encode()).hexdigest()[:16]
    root = os.path.join(_CACHE_ROOT, "pip")
    dest = os.path.join(root, digest)
    if os.path.isdir(dest):
        return dest
    os.makedirs(root, exist_ok=True)
    import fcntl

    lock_path = os.path.join(root, f".{digest}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isdir(dest):  # another worker built it while we waited
            return dest
        tmp = tempfile.mkdtemp(prefix=f".{digest}-", dir=root)
        cmd = [sys.executable, "-m", "pip", "install",
               "--target", tmp, "--quiet", *opts, *packages]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pip runtime env build failed "
                    f"({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
            os.rename(tmp, dest)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return dest


def _build_locked(root: str, digest: str, build_fn) -> str:
    """Content-addressed build under an exclusive flock with atomic
    rename into place (same discipline as :func:`_ensure_pip_env`)."""
    import fcntl

    dest = os.path.join(root, digest)
    if os.path.isdir(dest):
        return dest
    os.makedirs(root, exist_ok=True)
    lock_path = os.path.join(root, f".{digest}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isdir(dest):
            return dest
        tmp = tempfile.mkdtemp(prefix=f".{digest}-", dir=root)
        try:
            build_fn(tmp)
            os.rename(tmp, dest)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return dest


def _ensure_venv(pip_spec: Dict[str, Any]) -> str:
    """Build (once, content-addressed) a virtualenv with the requested
    packages; returns its python executable (reference ``pip.py``'s
    ``_PathHelper.get_virtualenv_python``).  ``--system-site-packages``
    keeps the baked-in deps (jax et al) visible; installed packages
    shadow them, which is exactly the version-conflict isolation the
    sys.path mode cannot give."""
    import subprocess

    packages = pip_spec.get("packages", [])
    opts = pip_spec.get("pip_install_options", [])
    digest = hashlib.sha256(
        json.dumps(["venv", packages, opts, sys.version_info[:2],
                    sys.executable],
                   sort_keys=True).encode()).hexdigest()[:16]

    def build(tmp: str) -> None:
        import glob
        import venv

        venv.create(tmp, with_pip=True, system_site_packages=True)
        # when THIS interpreter is itself a venv (common container
        # layout), system-site-packages exposes the real system python's
        # site dir, not ours — link our site dirs in via a .pth so the
        # baked-in deps stay importable (venv installs still shadow
        # them: the venv's own site dir sorts first)
        parent_sites = [p for p in sys.path
                        if p.rstrip("/").endswith(("site-packages",
                                                   "dist-packages"))]
        vsites = glob.glob(os.path.join(tmp, "lib", "python*",
                                        "site-packages"))
        if parent_sites and vsites:
            with open(os.path.join(vsites[0], "_parent_site.pth"),
                      "w") as f:
                f.write("\n".join(parent_sites) + "\n")
        py = os.path.join(tmp, "bin", "python")
        if packages:
            proc = subprocess.run(
                [py, "-m", "pip", "install", "--quiet", *opts,
                 *packages],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"venv runtime env build failed:\n"
                    f"{proc.stderr[-4000:]}")

    dest = _build_locked(os.path.join(_CACHE_ROOT, "venv"), digest, build)
    return os.path.join(dest, "bin", "python")


def _ensure_conda_env(spec: Any) -> str:
    """Resolve a conda env to its python executable; a dict spec is
    created once (content-addressed prefix), a string names an existing
    env (reference ``conda.py`` ``get_conda_env_executable``)."""
    import subprocess

    conda = conda_binary()
    if conda is None:
        raise RuntimeError(
            "runtime_env['conda'] needs a conda binary on the worker "
            "host (set RAY_TPU_TORCH_CONDA_BIN or install conda)")
    if isinstance(spec, str):
        # named env: ask conda where it lives
        proc = subprocess.run([conda, "run", "-n", spec, "python", "-c",
                               "import sys; print(sys.executable)"],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"conda env {spec!r} not usable:\n"
                               f"{proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        interpreter = lines[-1].strip() if lines else ""
        if not interpreter or not os.path.exists(interpreter):
            raise RuntimeError(
                f"conda env {spec!r} resolved no usable interpreter "
                f"(conda stdout: {proc.stdout[-500:]!r})")
        return interpreter
    digest = hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]

    def build(tmp: str) -> None:
        env_yml = os.path.join(tmp, "environment.yml")
        os.makedirs(tmp, exist_ok=True)
        with open(env_yml, "w") as f:
            json.dump(spec, f)  # yaml parsers accept the JSON subset
        prefix = os.path.join(tmp, "env")
        proc = subprocess.run(
            [conda, "env", "create", "--prefix", prefix, "--file",
             env_yml, "--quiet"],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise RuntimeError(f"conda env create failed:\n"
                               f"{proc.stderr[-4000:]}")

    dest = _build_locked(os.path.join(_CACHE_ROOT, "conda"), digest,
                         build)
    return os.path.join(dest, "env", "bin", "python")


def resolve_worker_command(env_spawn: Dict[str, Any],
                           base_cmd: List[str],
                           mounts: Optional[List[str]] = None,
                           passthrough_env: Optional[Dict[str, str]]
                           = None) -> List[str]:
    """Raylet side: rewrite the worker launch argv for an isolated env.
    ``base_cmd`` is ``[python, -m, ray_tpu_torch.core.worker_main, ...]``;
    the interpreter is substituted (venv/conda/py_executable) or the
    whole command is wrapped in a container runtime.  May block on an
    env build — call off the io loop."""
    cmd = list(base_cmd)
    if env_spawn.get("py_executable"):
        cmd[0] = env_spawn["py_executable"]
    elif env_spawn.get("pip_venv"):
        cmd[0] = _ensure_venv(env_spawn["pip_venv"])
    elif env_spawn.get("conda"):
        cmd[0] = _ensure_conda_env(env_spawn["conda"])
    container = env_spawn.get("container")
    if container:
        runtime = container_binary()
        if runtime is None:
            raise RuntimeError(
                "runtime_env['container'] needs a container runtime on "
                "the worker host (set RAY_TPU_TORCH_CONTAINER_BIN)")
        # host network+IPC: the worker must reach the raylet's TCP port
        # and map the /dev/shm object store; the session dir carries
        # logs and sockets.  The image must have ray_tpu importable
        # (reference ``container.py`` has the same contract) — the
        # package dir is bind-mounted for same-host images.
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        run = [runtime, "run", "--rm", "--network=host", "--ipc=host",
               "-v", "/dev/shm:/dev/shm", "-v", f"{pkg_root}:{pkg_root}",
               "--env", f"PYTHONPATH={pkg_root}"]
        # the worker's identity env (env hash, spawn token) must cross
        # the container boundary — Popen's env stops at the client
        for k, v in (passthrough_env or {}).items():
            run += ["--env", f"{k}={v}"]
        for m in (mounts or []):
            run += ["-v", f"{m}:{m}"]
        for opt in container.get("run_options", []):
            run.append(str(opt))
        image = container["image"]
        inner_py = container.get("py_executable", "python3")
        run += [image, inner_py, *cmd[1:]]
        return run
    return cmd


class RuntimeEnvManager:
    """Worker side: apply envs once per (env, process).

    Parity: the runtime-env agent's ``CreateRuntimeEnv`` +
    ``RuntimeEnvManager`` URI bookkeeping, collapsed into the worker
    (no separate agent process — extraction is cheap and cached)."""

    def __init__(self, kv_get):
        self._kv_get = kv_get
        self._applied: set = set()

    def ensure_applied(self, runtime_env: Optional[Dict[str, Any]]) -> None:
        if not runtime_env:
            return
        key = env_hash(runtime_env)
        if key in self._applied:
            return
        for k, v in runtime_env.get("env_vars", {}).items():
            os.environ[str(k)] = str(v)
        pip = runtime_env.get("pip")
        if pip:
            pip = _normalize_pip(pip)
            # venv isolation applied at spawn (this worker already runs
            # under the venv interpreter); path mode injects here
            if pip.get("isolation") != "venv":
                pip_dir = _ensure_pip_env(pip)
                if pip_dir not in sys.path:
                    sys.path.insert(0, pip_dir)
        for uri in runtime_env.get("py_modules", []):
            root = _extract(uri, self._kv_get)
            if root not in sys.path:
                sys.path.insert(0, root)
        wd = runtime_env.get("working_dir")
        if wd:
            root = _extract(wd, self._kv_get)
            os.chdir(root)
            if root not in sys.path:
                sys.path.insert(0, root)
        self._applied.add(key)
