"""The port's shard engine over ``torch.distributed`` (gloo on the CPU).

Each rank takes its contiguous slice of the sampled cohort; the payload
sum is an ``all_reduce``, the new state rows and the upload counts are
gathered into cohort order, and the server step runs on every rank.

Tolerances:
- a one-rank group against the vmap engine, on the star and as the leaf
  backend of the hierarchical and ring topologies: bitwise (the all_reduce
  and the gathers of one rank change no bit);
- two ranks, spawned as two processes: every rank ends with the same bits
  (the all_reduce hands both the same sum); against the vmap run the
  upload nnz and ledger bytes exact, params within 1e-6 of each leaf's
  largest magnitude (the two ranks' partial sums are added in another
  order than vmap's single sum, one float32 rounding a round); the same
  on a tree of mixed dtypes (``MixedTiny``: a bfloat16 weight, ROADMAP
  item 15) on the star under dgcwgmf and global top-k, the ring and the
  hierarchy.

The two ranks also run the pinned ``shard_dgcwgmf`` round of
``repro_torch.analysis.jaxpr_audit`` at two ranks under
``CollectiveTally``: its collectives (kinds, result bytes, operand dtypes
and reduce ops) equal those of the same round on fake tensors in a fake
world of two ranks, the analysis's collective gate.

Process groups start from a ``file://`` store in the test's temporary
directory (no port is opened), and the spawned ranks have their own
timeout.
"""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
import torch.distributed as dist  # noqa: E402

from repro_torch.core import CompressionConfig  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulator  # noqa: E402
from repro_torch.fl.engine import ShardMapEngine, check_group_backend  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D_IN, D_OUT = 12, 4
RUNS = {  # name -> (FLConfig fields, CompressionConfig fields)
    "star": (dict(), dict(scheme="dgcwgmf")),
    "hierarchical": (dict(topology="hierarchical", groups=2), dict(scheme="hier_dgcwgmf")),
    "ring": (dict(topology="ring", ring_hops=1, sync_every=2), dict(scheme="dgc")),
}


class Tiny:
    """Linear-softmax classifier on fixed random data, numpy-seeded params."""

    def __init__(self, num_clients=8, samples=16, seed=0):
        rng = np.random.default_rng(seed)
        self.x = torch.from_numpy(rng.normal(size=(num_clients, samples, D_IN)).astype(np.float32))
        self.y = torch.from_numpy(rng.integers(0, D_OUT, size=(num_clients, samples)))
        self.w = (0.1 * rng.normal(size=(D_IN, D_OUT))).astype(np.float32)

    def init_fn(self, gen):
        return {"w": torch.from_numpy(self.w.copy()), "b": torch.zeros(D_OUT)}

    @staticmethod
    def loss_fn(params, batch):
        x, y = batch
        logp = torch.log_softmax(x @ params["w"] + params["b"], dim=-1)
        return -torch.mean(torch.gather(logp, -1, y[..., None]))

    def provider(self):
        return lambda t, ids, rng: (self.x[torch.as_tensor(ids)], self.y[torch.as_tensor(ids)])


class MixedTiny(Tiny):
    """Tiny with a bfloat16 weight beside the float32 bias: a tree of mixed
    dtypes (two dtype groups, ROADMAP item 15)."""

    def init_fn(self, gen):
        return {"w": torch.from_numpy(self.w.copy()).to(torch.bfloat16), "b": torch.zeros(D_OUT)}

    @staticmethod
    def loss_fn(params, batch):
        x, y = batch
        logp = torch.log_softmax(x @ params["w"].float() + params["b"], dim=-1)
        return -torch.mean(torch.gather(logp, -1, y[..., None]))


# the mixed tree's runs: the star under dgcwgmf and global top-k, the ring
# and the hierarchy
MIXED_RUNS = {
    "mixed_star": (dict(), dict(scheme="dgcwgmf")),
    "mixed_global": (dict(), dict(scheme="dgc", per_tensor=False)),
    "mixed_ring": (dict(topology="ring", ring_hops=1, sync_every=2), dict(scheme="dgc")),
    "mixed_hierarchical": (dict(topology="hierarchical", groups=2),
                           dict(scheme="hier_dgcwgmf")),
}


def run(name, backend, clients_per_round=8, rounds=4, group=None):
    fl_kw, comp_kw = RUNS[name] if name in RUNS else MIXED_RUNS[name]
    task = Tiny() if name in RUNS else MixedTiny()
    fl = FLConfig(num_clients=8, rounds=rounds, clients_per_round=clients_per_round,
                  batch_size=16, learning_rate=0.5, seed=0, backend=backend, **fl_kw)
    sim = FLSimulator(fl, CompressionConfig(rate=0.25, tau=0.4, **comp_kw), task.init_fn,
                      task.loss_fn, device="cpu", group=group)
    sim.run(task.provider())
    return sim


def state(sim):
    """Everything a run leaves, as named numpy arrays (a tree of mixed
    dtypes: float32 copies, one array per dtype group)."""
    if isinstance(sim.gbar_prev, tuple):
        return mixed_state(sim)
    out = {f"params/{k}": v.numpy() for k, v in sim.params.items()}
    for name, x in zip("uvm", sim.cstates, strict=True):
        if torch.is_tensor(x):
            out[f"client/{name}"] = x.numpy()
    for name, x in zip(("momentum", "residual"), sim.sstate, strict=True):
        if torch.is_tensor(x):
            out[f"server/{name}"] = x.numpy()
    out["gbar_prev"] = sim.gbar_prev.numpy()
    out["ledger"] = np.asarray([sim.ledger.upload_bytes, sim.ledger.download_bytes,
                                sim.ledger.peer_bytes])
    if "upload_nnz" in sim.history[0]:  # the star's per-client counts, gathered
        out["upload_nnz"] = np.asarray([rec["upload_nnz"] for rec in sim.history])
    return out


def mixed_state(sim):
    out = {f"params/{k}": v.float().numpy() for k, v in sim.params.items()}
    fields = [(f"client/{n}", x) for n, x in zip("uvm", sim.cstates, strict=True)]
    fields += [(f"server/{n}", x) for n, x in zip(("momentum", "residual"), sim.sstate,
                                                  strict=True)]
    for name, x in fields + [("gbar_prev", sim.gbar_prev)]:
        if isinstance(x, tuple):
            out.update({f"{name}/{i}": g.float().numpy() for i, g in enumerate(x)})
    out["ledger"] = np.asarray([sim.ledger.upload_bytes, sim.ledger.download_bytes,
                                sim.ledger.peer_bytes])
    if "upload_nnz" in sim.history[0]:
        out["upload_nnz"] = np.asarray([rec["upload_nnz"] for rec in sim.history])
    return out


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(RUNS))
def test_one_rank_is_vmap_bitwise(one_rank_group, name):
    want = state(run(name, "vmap"))
    sim = run(name, "shard")
    assert sim.engine.shards.world == 1
    assert isinstance(sim.engine, ShardMapEngine) == (name == "star")
    got = state(sim)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_shard_validation_in_one_rank_group(one_rank_group):
    task = Tiny()
    fl = FLConfig(num_clients=8, rounds=1, backend="shard", shards=2)
    with pytest.raises(ValueError, match="FLConfig.shards=2 but the process group has 1 ranks"):
        FLSimulator(fl, CompressionConfig(scheme="dgc"), task.init_fn, task.loss_fn,
                    device="cpu")
    fl = FLConfig(num_clients=8, rounds=1, backend="shard", shards=1)
    FLSimulator(fl, CompressionConfig(scheme="dgc"), task.init_fn, task.loss_fn, device="cpu",
                group=one_rank_group)


@pytest.mark.parametrize("name", ["star", "hierarchical"])
def test_shard_needs_a_process_group(name):
    if dist.is_initialized():
        pytest.fail("a process group leaked from another test")
    with pytest.raises(RuntimeError, match="init_process_group"):
        run(name, "shard")


@pytest.mark.parametrize("backend, device, ok", [
    ("gloo", "cpu", True), ("nccl", "cuda", True), ("nccl", "cpu", False),
    ("gloo", "cuda", False), ("gloo", "meta", False)])
def test_group_backend_fits_the_device(backend, device, ok):
    if ok:
        check_group_backend(backend, device)
    else:
        with pytest.raises(ValueError, match="shard backend"):
            check_group_backend(backend, device)


# ---------------------------------------------------------------------------
# two ranks, two processes
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, init: str, out: str) -> None:
    """One rank of the spawned group: every run of ``RUNS`` and
    ``MIXED_RUNS`` on the shard backend, saved to ``out``, and the
    cohort-divisibility error."""
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        saved = {}
        for name in [*RUNS, *MIXED_RUNS]:
            saved.update({f"{name}/{k}": v for k, v in state(run(name, "shard")).items()})
        try:
            run("star", "shard", clients_per_round=3)
        except ValueError as e:
            saved["error"] = np.asarray(str(e))
        saved["tally"] = np.asarray(json.dumps(pinned_tally(fake=False)))
        np.savez(out, **saved)
    finally:
        dist.destroy_process_group()


def pinned_tally(fake: bool) -> dict:
    """The collectives of the analysis's pinned ``shard_dgcwgmf`` round at two
    ranks: over the caller's world on CPU tensors, or (``fake``) on fake ones
    in a fake world of two."""
    from repro_torch.analysis import jaxpr_audit

    tally = jaxpr_audit.audit_pinned("shard_dgcwgmf", device="cpu", world=2, fake=fake).tally
    return {"counts": tally.counts, "bytes": tally.bytes, "calls": [list(c) for c in tally.calls]}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two spawned ranks' saved runs."""
    tmp_path = tmp_path_factory.mktemp("two_ranks")
    init = f"file://{tmp_path / 'store'}"
    code = ("import sys; sys.path[:0] = sys.argv[5:7]; import test_torch_shard as t; "
            "t.rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), "2", init,
                               str(tmp_path / f"rank{r}.npz"), str(ROOT / "tests"),
                               str(ROOT / "src")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]


def test_two_ranks_agree_with_vmap(two_ranks):
    r0, r1 = two_ranks
    assert sorted(r0.files) == sorted(r1.files)
    for key in r0.files:
        assert np.array_equal(r0[key], r1[key]), key
    assert "divisible by the number of ranks (2)" in str(r0["error"])
    for name in RUNS:
        want = state(run(name, "vmap"))
        for key, w in want.items():
            got = r0[f"{name}/{key}"]
            if key in ("ledger", "upload_nnz"):
                assert np.array_equal(got, w), f"{name}/{key}"
            else:
                scale = max(float(np.abs(w).max()), 1e-30)
                assert np.abs(got - w).max() <= 1e-6 * scale, f"{name}/{key}"


def test_fake_world_tally_is_the_gloo_worlds(two_ranks):
    if dist.is_initialized():
        pytest.fail("a process group leaked from another test")
    gloo = json.loads(str(two_ranks[0]["tally"]))
    assert gloo == json.loads(str(two_ranks[1]["tally"]))
    assert pinned_tally(fake=True) == gloo
    assert gloo["counts"] == {"all-reduce": 1, "all-gather": 4}


@pytest.mark.parametrize("name", list(MIXED_RUNS))
def test_two_ranks_agree_with_vmap_on_a_mixed_tree(two_ranks, name):
    """A bfloat16 weight beside a float32 bias (two dtype groups, each state
    a tuple of stacks) over two ranks: both ranks the same bits, against the
    vmap run the upload nnz and ledger bytes exact, every array within 1e-6
    of its largest magnitude (as the float32 runs: no bfloat16 rounding of
    the two ranks' sum falls on the other side here)."""
    r0, r1 = two_ranks
    want = state(run(name, "vmap"))
    assert any(k.endswith("/1") for k in want)  # the second dtype group
    for key, w in want.items():
        got = r0[f"{name}/{key}"]
        assert np.array_equal(got, r1[f"{name}/{key}"]), f"{name}/{key}"
        if key in ("ledger", "upload_nnz"):
            assert np.array_equal(got, w), f"{name}/{key}"
        else:
            tol = 1e-6
            scale = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(got - w).max() <= tol * scale, f"{name}/{key}"
