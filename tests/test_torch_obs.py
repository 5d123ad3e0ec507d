"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU.

The simulator runs use ``tests/test_obs.py``'s tiny task (a linear-softmax
classifier with ``[6, 3]`` weights, 4 clients, rate 0.5, τ 0.4), its
params drawn by JAX and carried across with ``from_jax_params``.

Tolerances:
- the registries, exporters, the report and schema validation: equal (the
  port's copies of the reference's pure-Python modules);
- event streams of the same run in both packages: the kinds and their
  order equal; bytes, nnz, rounds, τ, staleness gaps and flags exact; the
  health norms within 1e-5 relative (float32 sums in another order than
  XLA's, and params one rounding apart under jit, ROADMAP R3); ``ts`` and
  ``wall_ms`` (host clocks) left out;
- the port's health norms against a float64 recomputation from the
  returned stacks: within 1e-6 relative;
- telemetry off against on, and a one-rank gloo shard run against vmap:
  bitwise.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.core.state import ClientState as JClientState  # noqa: E402
from repro.core.state import ServerState as JServerState  # noqa: E402
from repro.fl import FLConfig as JFL  # noqa: E402
from repro.fl import FLSimulator as JSim  # noqa: E402
from repro.obs import events as jevents  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import health as jhealth  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.core import ClientState, CompressionConfig, ServerState  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulator  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import events, export, health, metrics, report, trace  # noqa: E402
from repro_torch.utils.convert import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D_IN, D_OUT = 6, 3
NORM_RTOL = 1e-5
NORMS = ("residual_u_norm", "residual_v_norm", "momentum_m_norm", "server_momentum_norm",
         "global_momentum_norm", "broadcast_norm")
ROUND_PHASES = ("round.client_grads", "round.client_compress", "round.server_aggregate",
                "round.apply_update")
ADAPTIVE = dict(scheme="adaptive_dgcwgmf", rate_gain=0.5, rate_ema=0.0, rate_wire_threshold=1.2)
STRAGGLERS = dict(backend="async", buffer_size=2, delay_model="geometric", delay_mean=1.0,
                  delay_max=3, dropout_rate=0.1, rounds=6)
# name -> (FLConfig fields over _fl's, CompressionConfig fields)
RUNS = {
    "dgcwgmf": (dict(), dict(scheme="dgcwgmf")),
    "fetchsgd": (dict(), dict(scheme="fetchsgd")),
    "async": (STRAGGLERS, dict(scheme="async_dgcwgmf")),
    "ring": (dict(topology="ring", ring_hops=1, sync_every=2, clients_per_round=4),
             dict(scheme="dgc")),
    "hierarchical": (dict(topology="hierarchical", groups=2, clients_per_round=4),
                     dict(scheme="hier_dgcwgmf")),
    "adaptive": (dict(), ADAPTIVE),
    "adaptive_async": (STRAGGLERS, ADAPTIVE),
}
# the rate controller's outputs agree with JAX's within 1e-6 relative
# (tests/test_torch_rate_control.py), and so do their statistics
RATE_RTOL = 1e-6
RATE_KEYS = ("rate_mean", "rate_min", "rate_max")
RATE_METRICS = ("rate.effective", "fl.rate_mean")


@pytest.fixture(autouse=True)
def _reset_recorders():
    """Every test starts and ends with both packages' NOOP recorders."""
    obs.shutdown()
    jobs.shutdown()
    yield
    obs.shutdown()
    jobs.shutdown()


class Tiny:
    """``tests/test_obs.py``'s task in both packages."""

    def __init__(self, num_clients=4, samples=8, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(num_clients, samples, D_IN)).astype(np.float32)
        self.y = rng.integers(0, D_OUT, size=(num_clients, samples))
        self.tx, self.ty = torch.from_numpy(self.x), torch.from_numpy(self.y)

    @staticmethod
    def jax_init(key):
        return {"w": 0.1 * jax.random.normal(key, (D_IN, D_OUT)), "b": jnp.zeros((D_OUT,))}

    def torch_init(self, gen):
        # the JAX simulator draws its params from PRNGKey(seed), seed 0
        params = jax.tree_util.tree_map(np.asarray, self.jax_init(jax.random.PRNGKey(0)))
        return from_jax_params(params, layout="transformer")

    @staticmethod
    def jax_loss(params, batch):
        x, y = batch
        logp = jax.nn.log_softmax(x @ params["w"] + params["b"], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    @staticmethod
    def torch_loss(params, batch):
        x, y = batch
        logp = torch.log_softmax(x @ params["w"] + params["b"], dim=-1)
        return -torch.mean(torch.gather(logp, -1, y[..., None]))

    def jax_provider(self):
        return lambda t, ids, rng: (jnp.asarray(self.x[ids]), jnp.asarray(self.y[ids]))

    def torch_provider(self):
        return lambda t, ids, rng: (self.tx[torch.as_tensor(ids)], self.ty[torch.as_tensor(ids)])


def _fl(name):
    fl_kw, comp_kw = RUNS[name]
    kw = dict(num_clients=4, rounds=4, clients_per_round=2, learning_rate=0.5, seed=0)
    kw.update(fl_kw)
    return kw, dict(rate=0.5, tau=0.4, **comp_kw)


def port_sim(name, group=None, **fl_over):
    fl_kw, comp_kw = _fl(name)
    fl_kw.update(fl_over)
    task = Tiny()
    sim = FLSimulator(FLConfig(**fl_kw), CompressionConfig(**comp_kw), task.torch_init,
                      task.torch_loss, device="cpu", group=group)
    sim.run(task.torch_provider())
    return sim


def jax_sim(name):
    fl_kw, comp_kw = _fl(name)
    task = Tiny()
    sim = JSim(JFL(**fl_kw), JComp(**comp_kw), task.jax_init, task.jax_loss)
    sim.run(task.jax_provider())
    return sim


def _recorded(package, make_sim, out_dir, name):
    """A run recorded into ``out_dir`` as a launcher would: ``run_start``,
    the simulator's events, the ledger's ``summary``, the exporters.
    Returns (sim, events, registry snapshot)."""
    rec = package.configure(str(out_dir))
    try:
        backend = _fl(name)[0].get("backend", "vmap")
        rec.event("run_start", run=name, argv=[], backend=backend)
        sim = make_sim()
        rec.event("summary", **sim.ledger.summary())
        package.export.write_all(str(out_dir))
        snapshot = rec.registry.snapshot()
    finally:
        package.shutdown()
    return sim, package.events.read_events(str(out_dir / "events.jsonl")), snapshot


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each of ``RUNS`` recorded once in both packages (lazily, per name)."""
    root = tmp_path_factory.mktemp("obs_runs")
    cache = {}

    def get(name):
        if name not in cache:
            jdir, tdir = root / name / "jax", root / name / "port"
            jsim, jev, jsnap = _recorded(jobs, lambda: jax_sim(name), jdir, name)
            tsim, tev, tsnap = _recorded(obs, lambda: port_sim(name), tdir, name)
            cache[name] = dict(jsim=jsim, jev=jev, jsnap=jsnap, jdir=jdir, tsim=tsim, tev=tev,
                               tsnap=tsnap, tdir=tdir)
        return cache[name]

    return get


def assert_streams_match(got, want, rtol=NORM_RTOL):
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g["v"] == w["v"]
        gd, wd = g["data"], w["data"]
        assert sorted(gd) == sorted(wd), (i, g["kind"])
        for key, want_val in wd.items():
            if key == "wall_ms" or (g["kind"] == "run_start" and key == "argv"):
                continue
            if key in NORMS:
                assert gd[key] == pytest.approx(want_val, rel=rtol, abs=0), (i, key)
            elif key in RATE_KEYS:
                assert gd[key] == pytest.approx(want_val, rel=min(rtol, RATE_RTOL), abs=0), key
            else:
                assert gd[key] == want_val, (i, g["kind"], key)


# ---------------------------------------------------------------------------
# the pure-Python copies: registries, exporters, report, schema
# ---------------------------------------------------------------------------


def _replay(seed, recorder):
    """A seeded stream of metric operations into ``recorder``."""
    rng = np.random.default_rng(seed)
    names = ["comm.upload_bytes", "fl.round_ms", "fl.tau", "trace.span_ms", "x"]
    kinds = {n: ("counter", "histogram", "gauge", "histogram", "gauge")[i]
             for i, n in enumerate(names)}
    for _ in range(300):
        name = names[int(rng.integers(len(names)))]
        value = float(rng.normal() * 10.0 ** int(rng.integers(-3, 6)))
        labels = {} if rng.random() < 0.5 else {"span": f"s{int(rng.integers(3))}"}
        if kinds[name] == "counter":
            recorder.counter_add(name, abs(value), **labels)
        elif kinds[name] == "gauge":
            recorder.gauge_set(name, value, **labels)
        else:
            recorder.observe(name, value, **labels)
    return recorder.registry


@pytest.mark.parametrize("seed", range(4))
def test_registry_replay_matches_reference(seed):
    got, want = _replay(seed, metrics.Recorder()), _replay(seed, jmetrics.Recorder())
    assert got.snapshot() == want.snapshot()
    assert got.names() == want.names()
    assert export.prometheus_text(got) == jexport.prometheus_text(want)
    assert export.json_summary(got) == jexport.json_summary(want)
    # a reservoir past its bound keeps the same recent window
    h, jh = metrics.Histogram("h", max_samples=7), jmetrics.Histogram("h", max_samples=7)
    for v in np.random.default_rng(seed).normal(size=50):
        h.observe(v)
        jh.observe(v)
    assert h.snapshot() == jh.snapshot() and h.summary() == jh.summary()
    g, jg = metrics.Gauge("g"), jmetrics.Gauge("g")
    for v in (1, 3, 2, 0):
        g.set(v)
        jg.set(v)
    assert (g.value(), g.high_water()) == (jg.value(), jg.high_water()) == (0.0, 3.0)
    with pytest.raises(ValueError) as e_port:
        got.gauge("comm.upload_bytes")
    with pytest.raises(ValueError) as e_ref:
        want.gauge("comm.upload_bytes")
    assert str(e_port.value) == str(e_ref.value)


def test_configure_shutdown_and_exporters_when_disabled(tmp_path):
    assert obs.get() is metrics.NOOP and not obs.enabled()
    assert export.write_all(str(tmp_path)) == {}
    rec = obs.configure()  # metrics in memory only
    assert obs.enabled() and obs.get() is rec and rec.event_log is None
    rec.event("round", round=0)  # no sink: dropped
    obs.shutdown()
    assert obs.get() is metrics.NOOP
    assert os.listdir(tmp_path) == []


BAD_EVENTS = [
    "not an event",
    {},
    {"v": 2, "ts": 0.0, "kind": "round", "data": {}},
    {"v": "1", "ts": 0.0, "kind": "x", "data": {}},
    {"v": 1, "ts": "now", "kind": "x", "data": {}},
    {"v": 1, "ts": 0.0, "kind": "", "data": {}},
    {"v": 1, "ts": 0.0, "kind": "flush", "data": []},
    {"v": 1, "ts": 0.0, "kind": "flush", "data": {"round": 1}},
    {"v": 1, "ts": 0.0, "kind": "topo_round", "data": {"round": 1, "peer_bytes": 0}},
    {"v": 1, "ts": 0.0, "kind": "custom", "data": {}},
]


@pytest.mark.parametrize("ev", BAD_EVENTS, ids=range(len(BAD_EVENTS)))
def test_validate_event_matches_reference(ev):
    assert events.validate_event(ev) == jevents.validate_event(ev)
    assert events.KINDS == jevents.KINDS and events.SCHEMA_VERSION == jevents.SCHEMA_VERSION


def _long_run_events():
    """A 30-round log with loss, accuracy, an anomaly and a serve tail."""
    out = [events.make_event("run_start", run="long", argv=["--x"], backend="async", seed=3)]
    for t in range(30):
        out.append(events.make_event("round", round=t, wall_ms=10.0 + t, upload_bytes=1e6 * t,
                                     download_bytes=2e3, loss=1.0 / (t + 1), accuracy=0.1 * t,
                                     applies=1, pending=t % 3))
        out.append(events.make_event("health", round=t, residual_u_norm=0.5 * t,
                                     broadcast_norm=float(t), compression_achieved_rate=0.1,
                                     compression_target_rate=0.1))
        out.append(events.make_event("flush", round=t, staleness_gaps=[t % 4, 0]))
    out.append(events.make_event("anomaly", round=29, what="non-finite broadcast"))
    out.append(events.make_event("summary", rounds=30, upload_gb=0.5, hist={"a": 1}))
    return out


@pytest.mark.parametrize("source", ["dgcwgmf", "async", "hierarchical", "long", "bare",
                                    "serve"])
def test_report_matches_reference(runs, source, tmp_path, capsys):
    if source in RUNS:
        path = runs(source)["tdir"] / "events.jsonl"
        evs = events.read_events(str(path))
    else:
        evs = {"long": _long_run_events(),
               "bare": [events.make_event("round", round=0, wall_ms=1.0, upload_bytes=0,
                                          download_bytes=0)],
               "serve": [events.make_event("run_start", run="serve-x", argv=[],
                                           backend="serve"),
                         events.make_event("summary", tokens_per_s=3.5)]}[source]
        path = tmp_path / "events.jsonl"
        path.write_text("".join(json.dumps(e) + "\n" for e in evs))
    assert report.analyze(evs) == jreport.analyze(evs)
    for strict in ([], ["--strict"]):
        rc = report.main([str(path), *strict])
        out = capsys.readouterr()
        assert (rc, out.out, out.err) == (jreport.main([str(path), *strict]),
                                          *capsys.readouterr())
    if source in RUNS:
        assert report.main([str(path), "--strict"]) == 0


def test_report_rejects_schema_errors_like_reference(tmp_path):
    p = tmp_path / "events.jsonl"
    p.write_text(json.dumps({"v": 99, "ts": 0.0, "kind": "round", "data": {}}) + "\n")
    assert report.main([str(p)]) == jreport.main([str(p)]) == 1
    p.write_text("{not json\n")
    assert events.validate_file(str(p)) == jevents.validate_file(str(p))


# ---------------------------------------------------------------------------
# the simulator's event streams against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_event_stream_matches_jax(runs, name):
    r = runs(name)
    assert_streams_match(r["tev"], r["jev"])
    kinds = [e["kind"] for e in r["tev"]]
    rounds = r["tsim"].fl.rounds
    assert kinds.count("round") == rounds
    want_health = 2 * rounds if name == "hierarchical" else rounds
    assert kinds.count("health") == want_health
    if name == "hierarchical":
        tiers = [e["data"].get("tier") for e in r["tev"] if e["kind"] == "health"]
        assert tiers == [None, "aggregator"] * rounds
    if name == "async":
        flushes = [e["data"] for e in r["tev"] if e["kind"] == "flush"]
        gaps = [g for f in flushes for g in f["staleness_gaps"]]
        assert flushes and max(gaps) > 0
        hist = r["tsim"].ledger.staleness_counts
        assert sorted(gaps) == sorted(g for g, c in hist.items() for _ in range(c))
        last = [e["data"] for e in r["tev"] if e["kind"] == "health"][-1]
        want = float(np.sqrt(np.sum(r["tsim"].engine._gmom.double().numpy() ** 2)))
        assert last["global_momentum_norm"] == pytest.approx(want, rel=1e-6)
        assert want > 0


@pytest.mark.parametrize("name", list(RUNS))
def test_port_files_validate_under_reference(runs, name):
    r = runs(name)
    assert jevents.validate_file(str(r["tdir"] / "events.jsonl")) == []
    assert events.validate_file(str(r["jdir"] / "events.jsonl")) == []
    assert sorted(os.listdir(r["tdir"])) == ["events.jsonl", "metrics.prom", "summary.json"]


@pytest.mark.parametrize("name", list(RUNS))
def test_comm_counters_equal_ledger(runs, name):
    r = runs(name)
    led, snap = r["tsim"].ledger, r["tsnap"]

    def counter(metric):
        return snap[metric]["series"].get((), 0.0) if metric in snap else 0.0

    assert counter("comm.upload_bytes") == led.upload_bytes
    assert counter("comm.download_bytes") == led.download_bytes
    assert counter("comm.peer_bytes") == led.peer_bytes
    assert counter("comm.rounds") == float(led.rounds)
    gaps = snap.get("comm.staleness_gap", {"series": {}})["series"]
    assert (gaps[()]["count"] if gaps else 0) == sum(led.staleness_counts.values())
    # the same series and values as the JAX run's, bar the host clocks
    clocks = ("fl.round_ms", "trace.span_ms")
    skip = (*clocks, *RATE_METRICS)
    got = {k: v for k, v in snap.items() if k not in skip and not k.startswith("health.")}
    want = {k: v for k, v in r["jsnap"].items() if k not in skip and not k.startswith("health.")}
    assert got == want
    for k in RATE_METRICS:
        if k in snap:
            assert snap[k]["series"].keys() == r["jsnap"][k]["series"].keys()
            for key, cell in snap[k]["series"].items():
                assert cell == pytest.approx(r["jsnap"][k]["series"][key], rel=RATE_RTOL), k
    assert sorted(snap) == sorted(r["jsnap"])
    assert sorted(snap["trace.span_ms"]["series"]) == sorted(r["jsnap"]["trace.span_ms"]["series"])


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------


def _f64_norm(x):
    if not torch.is_tensor(x):
        return math.sqrt(sum(float(np.sum(v.double().numpy() ** 2)) for v in x.values()))
    return float(np.sqrt(np.sum(x.double().numpy() ** 2)))


@pytest.mark.parametrize("name", ["dgcwgmf", "fetchsgd"])
def test_health_norms_match_float64(runs, name):
    sim = runs(name)["tsim"]
    last = [e["data"] for e in runs(name)["tev"] if e["kind"] == "health"][-1]
    assert last["round"] == sim.fl.rounds - 1
    fields = {"residual_u_norm": sim.cstates.u, "residual_v_norm": sim.cstates.v,
              "momentum_m_norm": sim.cstates.m, "server_momentum_norm": sim.sstate.momentum,
              "broadcast_norm": sim.gbar_prev}
    for key, x in fields.items():
        assert last[key] == pytest.approx(_f64_norm(x), rel=1e-6, abs=0), key
    assert last["broadcast_finite"] is True
    assert last["compression_target_rate"] == 0.5


def _random_state(seed, n=21, k=4, empty=(), poison=None):
    """The same random state as the port's flat fields and the JAX
    package's trees ({"w": [..., 6, 3], "b": [..., 3]})."""
    rng = np.random.default_rng(seed)
    flat = {f: rng.normal(size=(k, n)).astype(np.float32) for f in "uvm"}
    flat["server"] = rng.normal(size=n).astype(np.float32)
    flat["gmom"] = rng.normal(size=n).astype(np.float32)
    flat["bcast"] = rng.normal(size=n).astype(np.float32)
    if poison is not None:
        flat["bcast"][3] = poison
    for f in empty:
        flat[f] = None

    def tree(a):
        if a is None:
            return {}
        lead = a.shape[:-1]
        return {"w": jnp.asarray(a[..., :18].reshape(*lead, 6, 3)), "b": jnp.asarray(a[..., 18:])}

    def port(a):
        return {} if a is None else torch.from_numpy(a.copy())

    jx = (JClientState(*(tree(flat[f]) for f in "uvm")), JServerState(tree(flat["server"]), {}),
          tree(flat["bcast"]), tree(flat["gmom"]))
    pt = (ClientState(*(port(flat[f]) for f in "uvm")), ServerState(port(flat["server"]), {}),
          port(flat["bcast"]), port(flat["gmom"]))
    return jx, pt


@pytest.mark.parametrize("empty, poison", [
    ((), None), (("u", "m", "server", "gmom"), None), (("v",), float("nan")),
    (("gmom",), float("inf"))])
def test_compensation_norms_match_reference(empty, poison):
    (jc, js, jb, jg), (tc, ts, tb, tg) = _random_state(7, empty=empty, poison=poison)
    want = jhealth.compensation_norms(jc, js, jb, gmom=jg)
    got = health.compensation_norms(tc, ts, tb, gmom=tg)
    assert sorted(got) == sorted(want)
    assert got["broadcast_finite"] is want["broadcast_finite"] is (poison is None)
    for key in NORMS:
        if math.isfinite(want[key]):
            assert got[key] == pytest.approx(want[key], rel=NORM_RTOL, abs=0), key
        else:
            assert not math.isfinite(got[key]), key
    for field in empty:
        key = {"u": "residual_u_norm", "v": "residual_v_norm", "m": "momentum_m_norm",
               "server": "server_momentum_norm", "gmom": "global_momentum_norm"}[field]
        assert got[key] == 0.0


def test_forced_nan_broadcast_trips_the_reference_anomaly(tmp_path):
    """One NaN in the broadcast trips the same anomaly event in both."""
    blocks, anomalies = [], []
    for package, hmod, make_sim, sub in ((jobs, jhealth, lambda: jax_sim("dgcwgmf"), "jax"),
                                         (obs, health, lambda: port_sim("dgcwgmf"), "port")):
        rec = package.configure(str(tmp_path / sub))
        sim = make_sim()
        if sub == "jax":
            bad = dict(sim.gbar_prev)
            bad["w"] = bad["w"].at[0, 0].set(jnp.nan)
        else:
            bad = sim.gbar_prev.clone()
            bad[0] = float("nan")
        blocks.append(hmod.record_round_health(
            rec, round_idx=4, cstates=sim.cstates, sstate=sim.sstate, bcast=bad,
            upload_nnz_mean=9.0, total_params=float(D_IN * D_OUT + D_OUT), target_rate=0.5))
        assert rec.registry.counter("health.anomalies").value() == 1.0
        package.shutdown()
        evs = package.events.read_events(str(tmp_path / sub / "events.jsonl"))
        anomalies.append([e["data"] for e in evs if e["kind"] == "anomaly"])
    (jblock, tblock), (janom, tanom) = blocks, anomalies
    assert tblock["broadcast_finite"] is jblock["broadcast_finite"] is False
    assert len(tanom) == len(janom) == 1
    assert {k: v for k, v in tanom[0].items() if k != "broadcast_norm"} == \
        {k: v for k, v in janom[0].items() if k != "broadcast_norm"} == \
        {"round": 4, "what": "non-finite broadcast"}
    assert math.isnan(tanom[0]["broadcast_norm"]) and math.isnan(janom[0]["broadcast_norm"])
    assert sim.gbar_prev.isfinite().all()  # the copy took the NaN


@pytest.mark.parametrize("args", [(50.0, 1000.0, 0.1), (9.0, 21.0, 0.5), (0.0, 0.0, 0.1),
                                  (7.0, 10.0, 0.0)])
def test_compression_ratio_matches_reference(args):
    assert health.compression_ratio(*args) == jhealth.compression_ratio(*args)


@pytest.mark.parametrize("hist", [{}, {0: 5, 1: 3, 4: 2}, {0: 40}, {2: 1, 0: 7, 9: 2, 3: 3}])
def test_staleness_percentiles_match_reference(hist):
    assert health.staleness_percentiles(hist) == jhealth.staleness_percentiles(hist)


# ---------------------------------------------------------------------------
# telemetry off: a no-op object, not a code path
# ---------------------------------------------------------------------------


def _state(sim):
    out = {f"params/{k}": v for k, v in sim.params.items()}
    for name, x in zip("uvm", sim.cstates, strict=True):
        if torch.is_tensor(x):
            out[f"client/{name}"] = x
    for name, x in zip(("momentum", "residual"), sim.sstate, strict=True):
        if torch.is_tensor(x):
            out[f"server/{name}"] = x
        elif isinstance(x, dict):
            out.update({f"server/{name}/{k}": v for k, v in x.items()})
    out["gbar_prev"] = sim.gbar_prev
    return out


@pytest.mark.parametrize("name", ["dgcwgmf", "async", "hierarchical"])
def test_telemetry_off_is_bitwise_on_and_writes_nothing(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    off = port_sim(name)
    assert obs.get() is metrics.NOOP
    assert os.listdir(tmp_path) == []
    rec = obs.configure(str(tmp_path / "obs"))
    on = port_sim(name)
    obs.shutdown()
    seen = events.read_events(str(tmp_path / "obs" / "events.jsonl"))
    a, b = _state(off), _state(on)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert off.ledger.summary() == on.ledger.summary()
    assert off.ledger.staleness_counts == on.ledger.staleness_counts
    assert [r["round"] for r in off.history] == [r["round"] for r in on.history]
    assert [e["kind"] for e in seen].count("round") == on.fl.rounds
    assert rec.registry.counter("comm.rounds").value() == on.ledger.rounds
    assert os.listdir(tmp_path) == ["obs"]


def test_disabled_spans_are_one_shared_object():
    assert obs.get() is metrics.NOOP
    s1, s2 = trace.span("x"), trace.span("y")
    assert s1 is s2 is trace._NULL_SPAN
    with s1:
        assert trace.current_path() == ""
    assert isinstance(trace.annotate_scope("round.client_grads"),
                      torch.profiler.record_function)


# ---------------------------------------------------------------------------
# spans, profiler ranges, NVTX
# ---------------------------------------------------------------------------


def test_spans_nest_with_the_reference_paths():
    rec, jrec = obs.configure(), jobs.configure()
    got_paths, want_paths = [], []
    with trace.span("round") as p1, jtrace.span("round") as q1:
        got_paths.append(p1)
        want_paths.append(q1)
        with trace.span("tick/dispatch") as p2, jtrace.span("tick/dispatch") as q2:
            got_paths.append(p2)
            want_paths.append(q2)
            assert trace.current_path() == jtrace.current_path() == "round/tick/dispatch"
            with trace.span("inner") as p3, jtrace.span("inner") as q3:
                got_paths.append(p3)
                want_paths.append(q3)
        with trace.span("aggregate") as p4, jtrace.span("aggregate") as q4:
            got_paths.append(p4)
            want_paths.append(q4)
    assert got_paths == want_paths == ["round", "round/tick/dispatch",
                                       "round/tick/dispatch/inner", "round/aggregate"]
    assert trace.current_path() == jtrace.current_path() == ""
    got = rec.registry.histogram("trace.span_ms").snapshot()["series"]
    want = jrec.registry.histogram("trace.span_ms").snapshot()["series"]
    assert sorted(got) == sorted(want)
    assert all(got[k]["count"] == want[k]["count"] == 1 for k in want)


@pytest.mark.parametrize("enabled", [False, True])
def test_round_phases_in_a_cpu_profile(enabled):
    from torch.profiler import ProfilerActivity, profile

    if enabled:
        obs.configure()
    fl_kw, comp_kw = _fl("dgcwgmf")
    fl_kw["rounds"] = 1
    task = Tiny()
    sim = FLSimulator(FLConfig(**fl_kw), CompressionConfig(**comp_kw), task.torch_init,
                      task.torch_loss, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(task.torch_provider())
    names = {e.name for e in prof.events()}
    assert set(ROUND_PHASES) <= names
    assert ("round" in names) is enabled  # the simulator's span, only when enabled


def test_no_nvtx_call_on_a_cpu_build(monkeypatch):
    if torch.version.cuda is not None:
        pytest.skip("a CUDA build: NVTX exists here")
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: calls.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append("pop"))
    trace.nvtx_available.cache_clear()
    obs.configure()
    with trace.span("round"), trace.annotate_scope("round.client_grads"):
        pass
    port_sim("async")
    assert not trace.nvtx_available()
    assert calls == []


# ---------------------------------------------------------------------------
# the shard backend and serving
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_group(tmp_path):
    import datetime

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", ["dgcwgmf", "hierarchical"])
def test_one_rank_shard_records_the_vmap_events(one_rank_group, name, tmp_path):
    streams = []
    for backend in ("vmap", "shard"):
        out = tmp_path / backend
        obs.configure(str(out))
        port_sim(name, backend=backend)
        obs.shutdown()
        streams.append(events.read_events(str(out / "events.jsonl")))
    assert_streams_match(streams[1], streams[0], rtol=0)


def test_serve_obs_writes_three_files_and_passes_strict(tmp_path):
    out = tmp_path / "obs"
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "3", "--obs", "--obs-dir", str(out)]
    assert serve.main(args) == 0
    assert obs.get() is metrics.NOOP
    assert sorted(os.listdir(out)) == ["events.jsonl", "metrics.prom", "summary.json"]
    evs = events.read_events(str(out / "events.jsonl"))
    assert [e["kind"] for e in evs] == ["run_start", "serve_summary", "summary"]
    assert evs[0]["data"]["argv"] == args and evs[0]["data"]["backend"] == "serve"
    assert evs[1]["data"]["requests"] == 2
    assert evs[2]["data"]["mode"] == "fixed" and evs[2]["data"]["batch"] == 2
    assert jevents.validate_file(str(out / "events.jsonl")) == []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                           str(out / "events.jsonl"), "--strict"], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "obs report: serve-llama3.2-1b run" in proc.stdout


def test_chip_smoke_splits_the_device_timeline_between_phases():
    """``chip_smoke.device_split`` on a hand-made trace (µs): a forward
    launched inside ``round.client_grads``, its backward launched from
    another thread (the autograd engine's), then one kernel per later
    phase. Each phase's window runs to the next phase's first kernel, so
    the backward counts toward the gradients; overlapping activities count
    once in the busy time."""
    import importlib.util
    from types import SimpleNamespace

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def ev(name, lo, hi, device="CUDA", annotation=False, device_ms=0.0):
        return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                               time_range=SimpleNamespace(start=lo, end=hi),
                               is_user_annotation=annotation, device_time_total=device_ms)

    events_ = [ev("fwd", 0, 10), ev("bwd", 10, 40), ev("bwd_overlap", 20, 30),
               ev("compress", 41, 42), ev("sum", 42.5, 43), ev("aggregate", 43, 43.5),
               ev("apply", 44, 46), ev("count_read", 47, 48)]
    for name, lo, hi, launched in ((ROUND_PHASES[0], 0, 10, 10.0), (ROUND_PHASES[1], 41, 42, 1.0),
                                   (ROUND_PHASES[2], 43, 43.5, 0.5),
                                   (ROUND_PHASES[3], 44, 46, 2.0)):
        events_.append(ev(name, lo, hi, annotation=True))
        events_.append(ev(name, lo - 1, hi + 1, device="CPU", device_ms=launched))
    n, busy, split = chip_smoke.device_split(SimpleNamespace(events=lambda: events_))
    assert n == 8 and busy == pytest.approx(45e-3)
    want = {ROUND_PHASES[0]: (10e-3, 40e-3), ROUND_PHASES[1]: (1e-3, 1.5e-3),
            ROUND_PHASES[2]: (0.5e-3, 0.5e-3), ROUND_PHASES[3]: (2e-3, 2e-3)}
    assert split.keys() == want.keys()
    for name, (launched, window) in want.items():
        assert split[name] == (pytest.approx(launched), pytest.approx(window)), name
