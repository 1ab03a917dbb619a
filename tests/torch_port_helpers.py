"""Shared helpers of the tests that hold the PyTorch port against the JAX
package on the CPU: parameters are made by the JAX init functions and cross
to the port through its weight bridge; inputs are numpy arrays from a seed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch import weights
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl)

META = tl.Init(None, "meta")


def bridge(jax_tree, template):
    """The port's copy of a JAX parameter subtree, on the CPU."""
    return weights.tree_from_jax(jax.tree.map(np.asarray, jax_tree), template,
                                 device="cpu")


def t(x, dtype=None):
    """numpy -> CPU tensor, optionally cast (bf16 goes through f32)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def j(x, dtype=None):
    out = jnp.asarray(np.array(x))
    return out if dtype is None else out.astype(dtype)


def assert_close(got, want, tol):
    """Port tensor against JAX array, compared in f32."""
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               rtol=tol, atol=tol)


def perturb(tree, rng, scale=0.1):
    """A numpy copy of a JAX tree with noise on every leaf, so that LN
    scales/biases and zero-initialised biases are not trivial."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.asarray(a).dtype), tree)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module of tiny-model tests: their many small
    ops gain nothing from a thread pool, and the suite's parallel workers
    share the host's cores, where each op's pool would wait on the others.
    The count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def offline_hub(monkeypatch):
    """Hugging Face hub lookups fail at once (HF_HUB_OFFLINE, also where the
    hub's constants were read before this test), and any attempt to
    resolve or reach a host fails the test instead of leaving."""
    import socket

    import huggingface_hub.constants

    attempts = []

    def refuse(*args, **kw):
        attempts.append(args[:2])
        raise OSError("network access refused by the test")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    for name in ("getaddrinfo", "create_connection"):
        monkeypatch.setattr(socket, name, refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)
    yield
    assert attempts == [], f"network access attempted: {attempts}"


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, tasks, results):
    """A rank of RankPool: joins the gloo group, then runs tasks until None."""
    import importlib
    import traceback

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            module, name, args = task
            try:
                value = getattr(importlib.import_module(module), name)(*args)
                results.put((rank, True, value))
            except BaseException:  # reported to the test, which fails with it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` processes joined in one gloo process group on the CPU,
    spawned once: run(fn, *args) calls the module-level fn(*args) on every
    rank and returns the ranks' results in rank order, or raises with a
    failing rank's traceback. Spawning a group costs seconds, so a test
    module makes one (the `two_ranks` fixture) and runs its checks in it."""

    def __init__(self, world: int = 2):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, world, port, self.tasks[r], self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, timeout: float = 180.0):
        for q in self.tasks:
            q.put((fn.__module__, fn.__name__, args))
        got = {}
        for _ in range(self.world):
            rank, ok, value = self.results.get(timeout=timeout)
            got[rank] = (ok, value)
        failed = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(got.items()) if not ok]
        if failed:
            raise AssertionError("\n".join(failed))
        return [got[r][1] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


@pytest.fixture(scope="module")
def two_ranks():
    """A RankPool of two gloo ranks for the module's tests."""
    pool = RankPool(2)
    yield pool
    pool.close()
