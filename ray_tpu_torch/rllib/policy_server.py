"""Client-server RL: external applications drive episodes remotely.

Parity: reference ``rllib/env/policy_server_input.py`` /
``policy_client.py`` — the application (e.g. a game server) runs
somewhere else and calls ``get_action``/``log_returns``; the RLlib side
hosts a :class:`PolicyServerInput` that serves those calls with the
current policy, assembles completed episodes into postprocessed
``SampleBatch`` es, and feeds them to the algorithm as its sampling
input (``config.rollouts(input_=lambda ctx: PolicyServerInput(ctx,
host, port))``).  Transport is the runtime's framed asyncio RPC
instead of the reference's HTTP long-poll.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

from ray_tpu_torch.core import rpc
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class _Episode:
    def __init__(self):
        self.rows: List[Dict[str, Any]] = []
        self.pending_obs: Optional[np.ndarray] = None
        self.pending_action: Optional[Dict[str, Any]] = None
        self.reward_since_action = 0.0
        self.total_reward = 0.0


class PolicyServerInput:
    """Input reader serving external episodes (one per Algorithm/worker).

    ``next()`` blocks until at least one completed episode is queued and
    returns the concatenated batches — the contract RolloutWorker
    expects from an input reader.
    """

    def __init__(self, ioctx: Any, address: str = "127.0.0.1",
                 port: int = 0):
        self.worker = ioctx  # RolloutWorker (for policy + postprocessing)
        self._batches: "queue.Queue[SampleBatch]" = queue.Queue()
        self._episodes: Dict[str, _Episode] = {}
        self._loop = asyncio.new_event_loop()
        self._server = rpc.Server(self, host=address, port=port)
        started = threading.Event()

        def _run():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self._server.start())
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="policy-server")
        self._thread.start()
        started.wait(10)
        self.address = self._server.address

    # -- RPC handlers (called on the server loop) -----------------------
    async def handle_start_episode(self, conn, data) -> Dict[str, Any]:
        eid = data.get("episode_id") or uuid.uuid4().hex
        self._episodes[eid] = _Episode()
        return {"episode_id": eid}

    async def handle_get_action(self, conn, data) -> Dict[str, Any]:
        ep = self._episodes[data["episode_id"]]
        obs = np.asarray(data["observation"])
        self._commit_transition(ep, obs, terminated=False)
        actions, extras = self.worker.policy.compute_actions(obs[None])
        action = np.asarray(actions)[0]
        ep.pending_obs = obs
        ep.pending_action = {
            SampleBatch.ACTIONS: action,
            **{k: np.asarray(v)[0] for k, v in extras.items()},
        }
        ep.reward_since_action = 0.0
        return {"action": action}

    async def handle_log_action(self, conn, data) -> Dict[str, Any]:
        """Off-policy actions chosen by the client (reference
        ``log_action``): recorded without policy extras."""
        ep = self._episodes[data["episode_id"]]
        obs = np.asarray(data["observation"])
        self._commit_transition(ep, obs, terminated=False)
        ep.pending_obs = obs
        ep.pending_action = {
            SampleBatch.ACTIONS: np.asarray(data["action"])}
        ep.reward_since_action = 0.0
        return {"ok": True}

    async def handle_log_returns(self, conn, data) -> Dict[str, Any]:
        ep = self._episodes[data["episode_id"]]
        ep.reward_since_action += float(data["reward"])
        ep.total_reward += float(data["reward"])
        return {"ok": True}

    async def handle_end_episode(self, conn, data) -> Dict[str, Any]:
        eid = data["episode_id"]
        ep = self._episodes.pop(eid)
        last_obs = np.asarray(data["observation"])
        self._commit_transition(ep, last_obs, terminated=True)
        if ep.rows:
            batch = SampleBatch(
                {k: np.stack([np.asarray(r[k]) for r in ep.rows])
                 for k in ep.rows[0]})
            batch = self.worker.policy.postprocess_trajectory(
                batch, last_obs, truncated=False)
            self._batches.put(batch)
            self.worker._completed_returns.append(ep.total_reward)
            self.worker._completed_lens.append(len(ep.rows))
        return {"ok": True}

    def _commit_transition(self, ep: _Episode, next_obs: np.ndarray,
                           terminated: bool) -> None:
        """The reward window since the last action closes when the next
        observation arrives (or the episode ends)."""
        if ep.pending_action is None:
            return
        row = {SampleBatch.OBS: ep.pending_obs,
               SampleBatch.NEXT_OBS: next_obs,
               SampleBatch.REWARDS: np.float32(ep.reward_since_action),
               SampleBatch.TERMINATEDS: terminated,
               SampleBatch.TRUNCATEDS: False}
        row.update(ep.pending_action)
        ep.rows.append(row)
        ep.pending_action = None

    # -- input-reader contract ------------------------------------------
    def next(self) -> SampleBatch:
        batches = [self._batches.get()]
        while True:
            try:
                batches.append(self._batches.get_nowait())
            except queue.Empty:
                break
        return concat_samples(batches)

    def close(self) -> None:
        async def _stop():
            await self._server.stop()

        asyncio.run_coroutine_threadsafe(_stop(), self._loop).result(5)
        self._loop.call_soon_threadsafe(self._loop.stop)


class PolicyClient:
    """The external application's side (reference ``PolicyClient``)."""

    def __init__(self, address):
        if isinstance(address, str):
            host, port = address.rsplit(":", 1)
            address = (host, int(port))
        self._address = tuple(address)
        self._closed = False
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True, name="policy-client")
        self._thread.start()
        self._conn = self._run(rpc.connect(self._address))

    def _run(self, coro):
        if self._closed:
            # the loop is stopped: run_coroutine_threadsafe would enqueue
            # a coroutine that never runs and stall the caller 30 s
            coro.close()
            raise ConnectionError("policy client is closed")
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(30)
        except (TimeoutError, rpc.ConnectionLost, rpc.RpcError) as e:
            # surface a single, catchable error class to the application
            # thread (an unbounded raw TimeoutError here used to die
            # unhandled in daemon threads during teardown)
            fut.cancel()
            logger.info("policy client call failed (%s)%s",
                        type(e).__name__,
                        " — client closed" if self._closed else "")
            raise ConnectionError(
                f"policy server call failed: {type(e).__name__}: {e}"
            ) from e

    def close(self) -> None:
        """Tear down the link; a concurrently blocked call fails fast with
        ConnectionError instead of waiting out its timeout."""
        if self._closed:
            return
        self._closed = True
        def _shut():
            self._conn.close()
            # conn.close() only SCHEDULES the waiter wakeups
            # (fut.set_exception -> call_soon); stopping in the same
            # callback would strand a blocked caller for its full
            # timeout — defer the stop one tick so the failures drain
            self._loop.call_soon(self._loop.stop)
        self._loop.call_soon_threadsafe(_shut)
        self._thread.join(5)

    def _call(self, method: str, data: Dict[str, Any]) -> Dict[str, Any]:
        return self._run(self._conn.call(method, data))

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        return self._call("start_episode",
                          {"episode_id": episode_id})["episode_id"]

    def get_action(self, episode_id: str, observation) -> np.ndarray:
        return np.asarray(self._call(
            "get_action", {"episode_id": episode_id,
                           "observation": np.asarray(observation)})
            ["action"])

    def log_action(self, episode_id: str, observation, action) -> None:
        self._call("log_action", {"episode_id": episode_id,
                                  "observation": np.asarray(observation),
                                  "action": np.asarray(action)})

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._call("log_returns", {"episode_id": episode_id,
                                   "reward": float(reward)})

    def end_episode(self, episode_id: str, observation) -> None:
        self._call("end_episode", {"episode_id": episode_id,
                                   "observation": np.asarray(observation)})

    def close(self) -> None:
        self._conn.close()
        self._loop.call_soon_threadsafe(self._loop.stop)
