"""Ranks as processes: the process group, the control plane, serving.

Counterpart of ``vattention_tpu/parallel/multihost.py``.  The JAX
package's multi-controller mode runs one process per host, each running
the same engine, the step spanning all of them; the port runs one process
per rank the same way.  Every process runs the same engine over identical
state (the scheduler, the allocator, the seeded sampler), so all that
must travel between them on the host is the admission of requests: the
driver (rank 0) broadcasts them with their arrival times and sequence ids
once per iteration over a small TCP control plane
(``RequestControlPlane``), and every process admits them at the same
iteration before it steps.  The model's collectives run in the step
(``parallel.mesh``).

- ``init_multihost`` starts the ``torch.distributed`` process group with a
  finite timeout; the backend follows ``mesh.pick_backend``.  A failed
  start raises.
- ``serve_multihost`` is the JAX loop: the driver submits requests and
  ticks, every process admits and steps.
- ``launch_ranks`` starts ranks as child processes of this entry point,
  ``python -m vattention_tpu_torch.parallel.multihost``, which runs one
  rank: it starts the process group (a ``FileStore`` in the launch's
  temporary directory, so concurrent launches never meet), calls the
  function it is given with that rank's device and store, and writes the
  function's result.  ``run_ranks`` runs every rank so and returns their
  results; ``LLMEngine`` starts the other ranks of an engine so
  (``start_engine_ranks``), its own process being rank 0, and they
  ``follow`` it.  A parent joins its children with a timeout, kills them
  on a failure or a timeout, and raises.

Ranks run on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``): with no CUDA device and no such
request, starting them raises.  Children inherit the caller's working
directory, so relative paths (a checkpoint's) name the same files on every
rank.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import pickle
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.parallel.mesh import pick_backend, ranks_per_device

logger = init_logger(__name__)

# collectives, rendezvous and the control plane give up after this long
DEFAULT_TIMEOUT_S = 300.0
# after a rank fails, how long its peers get to exit before they are killed
FAILURE_GRACE_S = 10.0
_REPO_ROOT = Path(__file__).resolve().parents[2]


def rank_device(kind: str, rank: int) -> torch.device:
    """Rank r's device: ``cuda:{r % device_count}``, or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unsupported device {kind!r}")
    _require_cuda()
    return torch.device("cuda", rank % torch.cuda.device_count())


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the ranks: pass device='cpu' "
                           "(--device cpu) to run them on the CPU")


def _store(coordinator_address: str, num_processes: int, process_id: int,
           timeout: datetime.timedelta):
    if coordinator_address.startswith("file://"):
        return dist.FileStore(coordinator_address[len("file://"):],
                              num_processes)
    host, port = coordinator_address.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), num_processes,
                         is_master=process_id == 0, timeout=timeout)


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, device: Optional[torch.device] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S):
    """Start the process group (the JAX ``jax.distributed.initialize``).

    ``coordinator_address``: ``file://<path>`` (a FileStore) or
    ``[tcp://]host:port`` (a TCPStore served by process 0).  ``device``
    is this process's (default ``rank_device("cuda", process_id)``; a
    CPU rank passes ``torch.device("cpu")``).  The backend is
    ``mesh.pick_backend``'s for it with the ``num_processes`` ranks on
    this host.  Returns the store, which the control plane reuses."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if device is None:
        device = rank_device("cuda", process_id)
    backend = pick_backend(device.type, ranks_per_device(num_processes,
                                                         device.type))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = _store(coordinator_address, num_processes, process_id, timeout)
    store.set_timeout(timeout)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    logger.info("process group up: rank %d of %d on %s, backend %s "
                "(nccl only when every rank owns a CUDA device), "
                "timeout %.0f s", process_id, num_processes, device, backend,
                timeout_s)
    return store


def _send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj)
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    data = b""
    while len(data) < n:
        chunk = sock.recv(min(n - len(data), 1 << 20))
        if not chunk:
            raise ConnectionError("control-plane peer closed")
        data += chunk
    return data


def _recv_msg(sock: socket.socket):
    n = struct.unpack("!I", _recv_exact(sock, 4))[0]
    return pickle.loads(_recv_exact(sock, n))


class RequestControlPlane:
    """Driver-side broadcast of request admissions.

    The driver (process 0) accepts its followers' connections and, once
    per engine iteration, sends ``("tick", iteration, requests, stop)``.
    Followers block on the marker before stepping, so every process admits
    the same requests at the same iteration.  The driver listens on
    ``driver_host:port`` (0: any free port, published in ``store`` under
    ``control_port`` for the followers) and followers connect there: the
    loopback interface by default, where every rank this package starts
    runs; ranks on other hosts need the driver's address on their
    network.  The plane carries pickled admissions without
    authentication, so it listens on no wider interface than that."""

    def __init__(self, process_id: int, num_processes: int, port: int = 0,
                 driver_host: str = "127.0.0.1", *, store=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.process_id = process_id
        self.num_processes = num_processes
        self.is_driver = process_id == 0
        self._pending: List[tuple] = []
        self._lock = threading.Lock()
        if self.is_driver:
            self._server = socket.create_server((driver_host, port))
            self._server.settimeout(timeout_s)
            if store is not None:
                store.set("control_port",
                          str(self._server.getsockname()[1]))
            self._peers: List[socket.socket] = []
            for _ in range(num_processes - 1):
                conn, _ = self._server.accept()
                conn.settimeout(None)
                self._peers.append(conn)
        else:
            if store is not None:
                port = int(store.get("control_port"))
            if not port:
                raise ValueError("a follower needs the driver's port or the "
                                 "store it is published in")
            self._sock = socket.create_connection((driver_host, port),
                                                  timeout=timeout_s)
            # a follower waits on its driver for as long as the driver's
            # caller takes between steps; a driver that dies closes it
            self._sock.settimeout(None)

    # -- driver side ---------------------------------------------------- #
    def submit(self, request_payload: tuple) -> None:
        """Queue a request for broadcast at the next tick (driver)."""
        assert self.is_driver
        with self._lock:
            self._pending.append(request_payload)

    def tick(self, iteration: int, *, stop: bool = False) -> List[tuple]:
        """Driver: flush queued requests to every follower and return
        them."""
        assert self.is_driver
        with self._lock:
            batch, self._pending = self._pending, []
        msg = ("tick", iteration, batch, stop)
        for peer in self._peers:
            _send_msg(peer, msg)
        return batch

    # -- follower side --------------------------------------------------- #
    def wait_tick(self, iteration: int):
        """Follower: block for the driver's marker for this iteration.
        Returns (requests, stop)."""
        assert not self.is_driver
        tag, it, batch, stop = _recv_msg(self._sock)
        if tag != "tick" or it != iteration:
            raise RuntimeError(f"control plane out of step: {tag} {it}, "
                               f"expected tick {iteration}")
        return batch, stop

    def close(self) -> None:
        if self.is_driver:
            for peer in self._peers:
                peer.close()
            self._server.close()
        else:
            self._sock.close()


def serve_multihost(engine, control: RequestControlPlane, *,
                    requests: Optional[List[dict]] = None,
                    max_steps: int = 10_000) -> dict:
    """The replicated continuous-batching loop.

    The driver admits ``requests`` (dicts of ``add_request`` keywords)
    through the control plane, stamping each one's arrival time once;
    every process, the driver included, admits the same requests at the
    same iteration and calls ``engine.step()``, whose collectives span all
    of them.  Returns {seq_id: token_ids} of the finished requests (the
    same on every process)."""
    outputs = {}
    queue = list(requests or [])
    it = 0
    while True:
        if control.is_driver:
            while queue:
                kwargs = dict(queue.pop(0))
                kwargs.setdefault("arrival_time", time.monotonic())
                control.submit(("add", kwargs))
            stop = (not queue and not engine.has_unfinished_requests()
                    and it > 0)
            batch = control.tick(it, stop=stop)
        else:
            batch, stop = control.wait_tick(it)
        for tag, kwargs in batch:
            assert tag == "add"
            engine.add_request(**kwargs)
        if stop:
            break
        for out in engine.step():
            if out.finished:
                outputs[out.seq_id] = out.token_ids
        it += 1
        if it >= max_steps:
            raise RuntimeError("multihost serve did not converge")
    return outputs


# --------------------------------------------------------------------- #
# ranks as child processes
# --------------------------------------------------------------------- #
class Ranks:
    """Child processes running ranks of one process group."""

    def __init__(self, run_dir: str, world: int, procs: Dict[int, Any]):
        self.run_dir = run_dir
        self.world = world
        self.procs = procs
        self.coordinator = f"file://{os.path.join(run_dir, 'store')}"

    def log_tail(self, rank: int, n: int = 4000) -> str:
        path = os.path.join(self.run_dir, f"rank{rank}.log")
        if not os.path.exists(path):
            return ""
        with open(path, errors="replace") as f:
            return f.read()[-n:]

    def kill(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            p.wait()

    def join(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> Dict[int, Any]:
        """Wait for every child; their results by rank.  A child that
        fails, or a join past ``timeout_s``, kills the others and raises
        with the failed ranks' output.  After the first failure the others
        get ``FAILURE_GRACE_S`` to exit on their own, so the report holds
        the rank that failed first even when a peer it left in a
        collective exits before it."""
        deadline = time.monotonic() + timeout_s
        failed = []
        while True:
            codes = {r: p.poll() for r, p in self.procs.items()}
            failed = [r for r, c in codes.items() if c not in (None, 0)]
            if failed:
                grace = time.monotonic() + FAILURE_GRACE_S
                while (time.monotonic() < grace and
                       any(p.poll() is None for p in self.procs.values())):
                    time.sleep(0.05)
                failed = [r for r, p in self.procs.items()
                          if p.poll() != 0]
                break
            if all(c == 0 for c in codes.values()):
                break
            if time.monotonic() > deadline:
                failed = [r for r, c in codes.items() if c is None]
                self.kill()
                raise RuntimeError(
                    f"ranks {failed} still running after {timeout_s:.0f} s:"
                    + "".join(f"\n--- rank {r} ---\n{self.log_tail(r)}"
                              for r in failed))
            time.sleep(0.05)
        if failed:
            self.kill()
            raise RuntimeError(
                f"ranks {failed} failed:"
                + "".join(f"\n--- rank {r} ---\n{self.log_tail(r)}"
                          for r in failed))
        results = {}
        for r in self.procs:
            with open(os.path.join(self.run_dir, f"result{r}.pkl"),
                      "rb") as f:
                results[r] = pickle.load(f)
        return results

    def remove(self) -> None:
        shutil.rmtree(self.run_dir, ignore_errors=True)


def _call_name(fn) -> str:
    return fn if isinstance(fn, str) else f"{fn.__module__}:{fn.__qualname__}"


def launch_ranks(fn, world: int, payload: Dict[str, Any], *,
                 device: str = "cuda", first_rank: int = 0,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> Ranks:
    """Start ranks ``first_rank .. world - 1`` as children, each calling
    ``fn(device=..., store=..., **payload)`` (``fn``: a function or its
    ``module:qualname``, importable by the children: they get this
    process's ``sys.path``) on ``device`` (``"cuda"`` or ``"cpu"``).  On
    CUDA the kernels and the allocator core are built here first, so the
    children only load them."""
    from vattention_tpu_torch.memory import native

    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if device == "cuda":
        _require_cuda()
    native.build()
    if device == "cuda":
        from vattention_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    run_dir = tempfile.mkdtemp(prefix="vattn-ranks-")
    with open(os.path.join(run_dir, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO_ROOT)] + [os.path.abspath(p) for p in sys.path if p])
    procs = {}
    for r in range(first_rank, world):
        log = open(os.path.join(run_dir, f"rank{r}.log"), "w")
        procs[r] = subprocess.Popen(
            [sys.executable, "-m", "vattention_tpu_torch.parallel.multihost",
             "--run-dir", run_dir, "--num-processes", str(world),
             "--process-id", str(r), "--call", _call_name(fn),
             "--device", device, "--timeout", str(timeout_s)],
            stdout=log, stderr=subprocess.STDOUT, env=child_env)
        log.close()
    return Ranks(run_dir, world, procs)


def run_ranks(fn, world: int, payload: Dict[str, Any], *,
              device: str = "cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn`` on every rank of a ``world``-rank process group, each
    rank a child process; their results in rank order."""
    ranks = launch_ranks(fn, world, payload, device=device,
                         timeout_s=timeout_s)
    try:
        results = ranks.join(timeout_s)
    finally:
        ranks.kill()
        ranks.remove()
    return [results[r] for r in range(world)]


# --------------------------------------------------------------------- #
# the engine's ranks
# --------------------------------------------------------------------- #
def engine_class(config):
    from vattention_tpu_torch.engine.base_llm_engine import BaseLLMEngine
    from vattention_tpu_torch.engine.pipeline_parallel_llm_engine import (
        PipelineParallelLLMEngine)

    if config.parallel_config.pipeline_parallel_size > 1:
        return PipelineParallelLLMEngine
    return BaseLLMEngine


def follow(*, device: torch.device, store, config) -> None:
    """A follower rank of an engine started by ``start_engine_ranks``:
    build the same engine on this rank and step it as the driver ticks,
    until the driver stops."""
    config.device = str(device)
    control = RequestControlPlane(dist.get_rank(), dist.get_world_size(),
                                  store=store)
    engine = engine_class(config)(config)
    try:
        serve_multihost(engine, control)
    finally:
        control.close()
        engine.cleanup()


def start_engine_ranks(config, timeout_s: float = DEFAULT_TIMEOUT_S):
    """The driver of a tp x pp engine called from one process: start ranks
    1 .. world - 1 as children that ``follow``, join the process group as
    rank 0 (``cuda:0`` or the CPU), and return rank 0's engine, whose
    ``add_request``, ``step`` and ``cleanup`` go through the control
    plane."""
    pc = config.parallel_config
    world = pc.tensor_parallel_size * pc.pipeline_parallel_size
    kind = torch.device(config.device).type
    device = rank_device(kind, 0)
    ranks = launch_ranks(follow, world, {"config": config}, device=kind,
                         first_rank=1, timeout_s=timeout_s)
    try:
        store = init_multihost(ranks.coordinator, world, 0, device=device,
                               timeout_s=timeout_s)
        control = RequestControlPlane(0, world, store=store,
                                      timeout_s=timeout_s)
        config.device = str(device)
        engine = engine_class(config)(config)
    except BaseException:
        ranks.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        logs = "".join(f"\n--- rank {r} ---\n{ranks.log_tail(r)}"
                       for r in ranks.procs)
        ranks.remove()
        logger.error("engine ranks failed to start:%s", logs)
        raise
    engine.attach_ranks(control, ranks)
    return engine


# --------------------------------------------------------------------- #
# one rank: python -m vattention_tpu_torch.parallel.multihost
# --------------------------------------------------------------------- #
def serve_requests(*, device: torch.device, store, runs: List[dict]
                   ) -> List[dict]:
    """Serve each run's requests through ``serve_multihost`` on this rank:
    ``runs`` are dicts of ``engine_args`` (``LLMEngine.from_engine_args``
    keywords) and ``requests`` (``add_request`` keywords, given to the
    driver).  Per run: the outputs, this rank's kernel launches (zeroed
    just before serving), the wall seconds, the steps' graphs, the
    backend, the rank's mesh coordinates, its arena's shape and the block
    moves its allocator planned."""
    from vattention_tpu_torch.engine.llm_engine import LLMEngine
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore
    from vattention_tpu_torch.ops.cuda_build import CudaKernel

    rank, world = dist.get_rank(), dist.get_world_size()
    control = RequestControlPlane(rank, world, store=store)
    results = []
    try:
        for run in runs:
            MetricsStore._instance = None
            engine = LLMEngine.from_engine_args(**run["engine_args"],
                                                device=str(device))
            mesh = engine.mesh
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            for k in CudaKernel.INSTANCES:
                k.launches = 0
            t0 = time.perf_counter()
            outputs = serve_multihost(
                engine, control,
                requests=run["requests"] if control.is_driver else None)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            runner = engine.worker.model_runner
            results.append(dict(
                outputs=outputs, wall=wall,
                launches={k.symbol: k.launches for k in CudaKernel.INSTANCES},
                graphs=len(runner.graphs),
                backend=dist.get_backend() if mesh is None else mesh.backend,
                coords=((0, 0, 0) if mesh is None else
                        (mesh.dp_rank, mesh.pp_rank, mesh.tp_rank)),
                arena=tuple(engine.worker.cache_engine.kv_cache.shape),
                moves=getattr(engine.worker.cache_engine, "pending_moves",
                              0)))
            engine.cleanup()
    finally:
        control.close()
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=(
        "Run one rank: start the process group, call a function with this "
        "rank's device and store, and write its result."))
    ap.add_argument("--run-dir", required=True,
                    help="holds payload.pkl (the call's keywords) and the "
                         "FileStore; result<rank>.pkl is written there")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--call", required=True, help="module:function")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (rank r on cuda:{r %% device_count}) "
                         "unless cpu is asked for")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    args = ap.parse_args(argv)
    module, name = args.call.split(":")
    fn: Any = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    with open(os.path.join(args.run_dir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    device = rank_device(args.device, args.process_id)
    store = init_multihost(
        f"file://{os.path.join(args.run_dir, 'store')}", args.num_processes,
        args.process_id, device=device, timeout_s=args.timeout)
    try:
        result = fn(device=device, store=store, **payload)
    finally:
        dist.destroy_process_group()
    path = os.path.join(args.run_dir, f"result{args.process_id}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # noqa: BLE001 -- the parent reads the log
        traceback.print_exc()
        sys.stdout.flush()
        # a rank that failed may leave threads in a collective behind
        os._exit(1)
    sys.exit(code)
