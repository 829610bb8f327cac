"""Run the reference on a forced P-device mesh and the port on P gloo ranks.

The mesh parity tests (``tests/test_torch_{partition,exchange,cluster}.py``)
hand both sides the same inputs, written once to an ``.npz``:

* ``run_reference(body, world, workdir)`` runs ``body`` in one interpreter
  with ``world`` forced host devices (``conftest.run_with_devices``); it
  sees ``WORLD``, ``mesh`` (axis ``"x"``), ``smap`` (jit of ``shard_map`` over it,
  replication unchecked),
  ``IN`` (the inputs) and fills ``out``, a dict of numpy arrays.
* ``run_port(body, world, workdir)`` runs ``body`` in ``world`` fresh
  interpreters, one rank each of a gloo group that meets through a
  ``FileStore`` in ``workdir`` (no TCP port, so parallel test workers never
  collide), polled together under the multihost harness's containment.
  It sees ``RANK``, ``WORLD``, ``G`` (the ``AxisGroup``),
  ``IN``, ``shard(a)`` (this rank's block of a global array, as a CPU
  tensor) and fills ``out``; the result is one dict per rank.

Both return the dicts; ``run_both`` starts the two sides at once.
``mesh_keys`` makes the seeded key sets the three files share.
``one_rank_mesh`` brings up a one-rank gloo group in the test's own
process and yields a (data=1, model=1) ``Mesh`` over it.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from _torch_multihost import contain, rank_env
from _torch_parity import bits
from conftest import REPO, run_with_devices

_REF_HEAD = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
WORLD = {world}
mesh = jax.make_mesh((WORLD,), ("x",))
IN = dict(np.load({inputs!r}))
out = {{}}
def smap(f, in_specs, out_specs):  # check_vma off: P() outputs of all_gathers
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))
"""

_PORT_HEAD = """
import os, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = {rank}, {world}
dist.init_process_group("gloo", store=dist.FileStore({store!r}, WORLD), rank=RANK,
                        world_size=WORLD)
from repro_torch.exchange import AxisGroup
G = AxisGroup()
IN = dict(np.load({inputs!r}))
out = {{}}
def shard(a):
    m = a.shape[0] // WORLD
    return torch.from_numpy(np.ascontiguousarray(a[RANK * m:(RANK + 1) * m]))
"""


@contextlib.contextmanager
def one_rank_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_debug_mesh()
    finally:
        dist.destroy_process_group()


def mesh_keys(kind: str, dtype: str, n: int, seed: int) -> np.ndarray:
    """Seeded keys; float32 keys carry -0.0 and +0.0 mixed (all-equal ones
    are nothing else)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.integers(-1_000_000, 1_000_000, n) if dtype == "int32" else rng.uniform(-1e3, 1e3, n)
    elif kind == "zipf":
        x = rng.zipf(1.5, n) % 10_000
    elif kind == "all_equal":
        x = np.full(n, 7)
    else:
        x = rng.integers(0, 5, n)
    x = x.astype(dtype)
    if dtype == "float32":
        zeros = np.where(np.arange(n) % 2 == 0, np.float32(0.0), np.float32(-0.0))
        x = zeros if kind == "all_equal" else np.where(np.arange(n) % 7 == 3, zeros, x)
    return x


def save_inputs(workdir: Path, arrays: dict) -> Path:
    path = Path(workdir) / "inputs.npz"
    np.savez(path, **arrays)
    return path


def run_reference(body: str, world: int, workdir: Path) -> dict:
    path = Path(workdir) / f"ref{world}.npz"
    head = _REF_HEAD.format(world=world, inputs=str(Path(workdir) / "inputs.npz"))
    run_with_devices(head + textwrap.dedent(body) + f"\nnp.savez({str(path)!r}, **out)\n",
                     n=world)
    return dict(np.load(path))


def run_port(body: str, world: int, workdir: Path, timeout: int = 600) -> list:
    """The port side: ``world`` ranks polled together under the multihost
    harness's containment (``_torch_multihost.contain``): the peers of a
    rank that fails end ``GRACE_AFTER_FAILURE_S`` later, a run past
    ``timeout`` seconds ends there, and the assertion carries every rank's
    log."""
    env = rank_env({"PYTHONPATH": os.path.join(REPO, "src")})
    store = Path(workdir) / f"store{world}"
    outs = [Path(workdir) / f"port{world}_rank{r}.npz" for r in range(world)]
    logs = [Path(workdir) / f"port{world}_rank{r}.log" for r in range(world)]
    procs = []
    for rank in range(world):
        head = _PORT_HEAD.format(rank=rank, world=world, store=str(store),
                                 inputs=str(Path(workdir) / "inputs.npz"))
        code = (head + textwrap.dedent(body)
                + f"\nnp.savez({str(outs[rank])!r}, **out)\ndist.destroy_process_group()\n")
        with open(logs[rank], "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
    timed_out, _ = contain(procs, timeout)
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not failed and not timed_out, (
        f"ranks failed {failed}{f' (run exceeded {timeout}s)' if timed_out else ''}:\n"
        + "\n".join(f"--- rank {r} ---\n{log.read_text(errors='replace')}"
                    for r, log in enumerate(logs)))
    return [dict(np.load(path)) for path in outs]


def run_both(ref_body: str, port_body: str, worlds, workdir: Path):
    """Reference and port at every world size, all started at once:
    ``({world: ref_dict}, {world: [rank_dict, ...]})``."""
    with ThreadPoolExecutor(max_workers=2 * len(worlds)) as pool:
        refs = {w: pool.submit(run_reference, ref_body, w, workdir) for w in worlds}
        ports = {w: pool.submit(run_port, port_body, w, workdir) for w in worlds}
        return ({w: f.result() for w, f in refs.items()},
                {w: f.result() for w, f in ports.items()})


def concat(ranks: list, name: str) -> np.ndarray:
    """The ranks' blocks of one output in rank order: the reference's
    ``P(axis)`` output."""
    return np.concatenate([r[name] for r in ranks])


def replicated(ranks: list, name: str) -> np.ndarray:
    """A ``P()`` output: the same on every rank."""
    first = ranks[0][name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(bits(r[name]), bits(first))
    return first
