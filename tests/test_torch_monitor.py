"""The port's LMS client (``repro_torch.core``) against ``repro.core``, on
the CPU.

* The copies: line protocol byte for byte, derived metrics to 1e-12
  relative, marker points and ``hpm`` points equal on the same inputs.
* The job/stack split: the port's training loop, through a
  ``RemoteStack``, into a ``repro.core`` stack served over HTTP in this
  process (lms-demo smoke, 4 steps, ``device="cpu"``), against the same
  run through the in-process stack.
* The calibration point: a port run stores the peaks it was given, and the
  stack's roofline of a port kernel region reads them (not the reference
  chip's constants).
* Findings come back through ``/alerts``; an unreachable stack raises at
  job start.
"""

import math
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, st

from repro.core import MonitoringStack  # noqa: E402
from repro.core import host_agent as jagent  # noqa: E402
from repro.core import line_protocol as jlp  # noqa: E402
from repro.core import marker as jmarker  # noqa: E402
from repro.core import perf_groups as jgroups  # noqa: E402
from repro.core import usermetric as jum  # noqa: E402
from repro.core.query import QueryEngine  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import RemoteStack  # noqa: E402
from repro_torch.core import host_agent as tagent  # noqa: E402
from repro_torch.core import line_protocol as tlp  # noqa: E402
from repro_torch.core import marker as tmarker  # noqa: E402
from repro_torch.core import perf_groups as tgroups  # noqa: E402
from repro_torch.core import usermetric as tum  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

H100 = {"PEAK_FLOPS": 989e12, "HBM_BW": 3.35e12}
PEAKS = {"peak_flops": H100["PEAK_FLOPS"], "hbm_bw": H100["HBM_BW"]}
TINY = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
S = 10**9

# -- line protocol ------------------------------------------------------------

POINTS = [
    ("m", {}, {"v": 1.0}, None),
    ("cpu load", {"host name": "a,b=c", "k": "v\\w"}, {"x y": 2.5}, 7),
    ("a,b", {"t=1": " lead"}, {"f,g": -0.0, "h=i": 1e-300}, 2**62),
    ("hpm", {"hostname": "h0"}, {"i": 42, "neg": -7, "big": 2**53}, 123),
    ("flags", {"r": "x"}, {"t": True, "f": False}, 1),
    ("ev", {"s": "1"}, {"event": 'say "hi"\nnext\rline \\ end'}, 5),
    ("ev", {}, {"event": ""}, None),
    ("nonfinite", {}, {"n": float("nan"), "p": float("inf"),
                       "q": float("-inf")}, 9),
    ("mixed", {"z": "1", "a": "2"},
     {"b": 3, "a": 0.1, "c": "str,with=seps", "d": True}, 10),
    ("unicode", {"tag": "äö"}, {"f": "ünï"}, 11),
]


def _pair(m, tags, fields, ts):
    return jlp.Point(m, dict(tags), dict(fields), ts), \
        tlp.Point(m, dict(tags), dict(fields), ts)


def _same_point(got, want):
    assert (got.measurement, got.tags, got.timestamp) == \
        (want.measurement, want.tags, want.timestamp)
    assert set(got.fields) == set(want.fields)
    for k, v in want.fields.items():
        g = got.fields[k]
        assert type(g) is type(v), k
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(g)
        else:
            assert g == v, k


@pytest.mark.parametrize("m,tags,fields,ts", POINTS)
def test_encode_point_is_byte_identical(m, tags, fields, ts):
    jp, tp = _pair(m, tags, fields, ts)
    line = tlp.encode_point(tp)
    assert line.encode() == jlp.encode_point(jp).encode()
    _same_point(tlp.decode_line(line), jlp.decode_line(line))


def test_encode_batch_is_byte_identical():
    pairs = [_pair(*p) for p in POINTS]
    data = tlp.encode_batch([t for _, t in pairs])
    assert data.encode() == jlp.encode_batch([j for j, _ in pairs]).encode()
    lines = data.split("\n")
    assert len(lines) == len(POINTS)
    for line in lines:
        _same_point(tlp.decode_line(line), jlp.decode_line(line))


@pytest.mark.parametrize("line", ["", "# c", "m", "m,t f=1", "m f=1 x",
                                  "m f=12xi", 'm f="open', "m f=?",
                                  ",t=1 f=1"])
def test_decode_line_rejects_what_the_reference_rejects(line):
    with pytest.raises(jlp.LineProtocolError):
        jlp.decode_line(line)
    with pytest.raises(tlp.LineProtocolError):
        tlp.decode_line(line)


_name = st.text(st.characters(codec="ascii", exclude_characters="\n\r"),
                min_size=1, max_size=12).filter(
    lambda s: s.strip() == s and not s.startswith("#"))
_value = st.one_of(st.integers(min_value=-2**60, max_value=2**60),
                   st.floats(allow_nan=False), st.booleans(),
                   st.text(max_size=12))


@settings(max_examples=200, deadline=None)
@given(m=_name, tags=st.dictionaries(_name, _name, max_size=3),
       fields=st.dictionaries(_name, _value, min_size=1, max_size=4),
       ts=st.one_of(st.none(), st.integers(min_value=0, max_value=2**62)))
def test_line_protocol_property(m, tags, fields, ts):
    """Any point encodes to the reference's bytes; its line decodes to the
    reference's point, or both decoders refuse it (the protocol cannot
    carry every name: a measurement starting with a quote, say)."""
    jp, tp = _pair(m, tags, fields, ts)
    line = tlp.encode_point(tp)
    assert line == jlp.encode_point(jp)
    try:
        want = jlp.decode_line(line)
    except jlp.LineProtocolError:
        with pytest.raises(tlp.LineProtocolError):
            tlp.decode_line(line)
        return
    _same_point(tlp.decode_line(line), want)


# -- performance groups -------------------------------------------------------

EVENTS = {
    "hlo_flops": 3.1e14, "model_flops": 2.7e14, "step_time_s": 0.41,
    "tokens_per_step": 16384.0, "data_wait_s": 0.003, "hlo_bytes": 9.2e11,
    "hbm_bytes_in_use": 5.1e10, "collective_bytes": 2.0e9,
    "wire_bytes": 3.5e9, "flops": 4.4e12, "bytes": 1.7e10, "time_s": 0.02,
}


@pytest.mark.parametrize("drop", [(), ("hlo_bytes",), ("data_wait_s",
                                                       "flops")])
def test_derive_all_matches_the_reference(drop):
    raw = {k: v for k, v in EVENTS.items() if k not in drop}
    raw.update(H100, ICI_BW=450e9)
    want, got = jgroups.derive_all(raw), tgroups.derive_all(raw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert math.isclose(got[k], v, rel_tol=1e-12), k
    for name in ("mfu", "hbm_bw_util", "roofline_frac", "ici_bw_util"):
        assert tgroups.formula_for(name) == jgroups.formula_for(name)
    assert tgroups.formula_for("FLOPS.mfu") == jgroups.formula_for(
        "FLOPS.mfu")
    assert tgroups.formula_for("NOPE.mfu") is None


def test_derive_all_carries_no_hardware_constants():
    """Without the peaks among the events the reference falls back to its
    chip's constants; the port skips those metrics."""
    raw = dict(EVENTS)
    want = jgroups.derive_all(raw)
    skipped = []
    got = tgroups.derive_all(raw, skipped=skipped)
    needs_peak = {"hw_flops_util", "mfu", "hbm_bw_util", "ici_bw_util",
                  "ici_wire_bw_util", "attainable_gflops", "roofline_frac"}
    assert set(want) - set(got) == needs_peak
    assert {name for name, _ in skipped} == needs_peak
    for k in got:
        assert math.isclose(got[k], want[k], rel_tol=1e-12), k
    assert not hasattr(tgroups, "PEAK_FLOPS")
    assert not hasattr(tgroups, "HW_CONSTANTS")


# -- emitters -----------------------------------------------------------------


class _Rec:
    """An emitter recording ``metric`` calls (the marker session's view of
    a UserMetric)."""

    def __init__(self):
        self.calls = []

    def metric(self, name, fields, tags=None, ts=None):
        self.calls.append((name, dict(fields), dict(tags or {}), ts))


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_markers(mod):
    """One sequence of regions under a fixed clock; returns the emitted
    calls, the returned flush dicts and the snapshot."""
    rec, clock = _Rec(), _Clock()
    mk = mod.MarkerSession(rec, emit_interval_s=10.0, clock=clock)
    with mk.region("outer", counters={"flops": 4.0, "bytes": 2.0}) as r:
        clock.t += 1.0
        with mk.region("inner"):
            clock.t += 0.25
        r.add(tokens=8)
        mk.start_region("leaked")
        clock.t += 0.5
    mk.record("data_wait", 0.125, counters={"bytes": 1.0})
    first = mk.flush(ts=5 * S)
    with mk.region("inner", counters={"flops": 1.5}):
        clock.t += 11.0             # past the interval: emits by itself
    mk.start_region("a")
    clock.t += 0.5
    mk.stop_region("a", counters={"flops": 2.0})
    with pytest.raises(ValueError):
        mk.stop_region("nothing-open")
    second = mk.close()
    return ([c[:3] for c in rec.calls], [c[3] for c in rec.calls],
            first, second, mk.snapshot())


def test_marker_points_match_the_reference():
    jcalls, jts, *jrest = _drive_markers(jmarker)
    tcalls, tts, *trest = _drive_markers(tmarker)
    assert tcalls == jcalls and trest == jrest
    assert tts[:3] == jts[:3] == [5 * S] * 3
    assert tmarker.MARKER_MEASUREMENT == jmarker.MARKER_MEASUREMENT
    assert tmarker.CALIB_REGION == jmarker.CALIB_REGION


def test_calibration_point_matches_the_reference():
    jr, tr = [], []
    jem = jum.UserMetric(jr.extend, hostname="h0", batch_size=100)
    tem = tum.UserMetric(tr.extend, hostname="h0", batch_size=100)
    try:
        jmarker.calibrate(jem, 989e12, 3.35e12, register=False, ts=7)
    finally:
        jmarker.register_roofline_group()
    tmarker.calibrate(tem, 989e12, 3.35e12, ts=7)
    assert [tlp.encode_point(p) for p in tr] == \
        [jlp.encode_point(p) for p in jr]
    assert len(tr) == 1 and tem.stats["sent_points"] == 1


def test_usermetric_points_match_the_reference():
    out = {}
    for name, mod, lp in (("jax", jum, jlp), ("port", tum, tlp)):
        got = []
        um = mod.UserMetric(got.extend, hostname="h0", batch_size=3,
                            default_tags={"rank": "0"})
        um.metric("train", {"loss": 2.5, "step": 3, "ok": True}, ts=1)
        um.metric("lr", 1e-3, tags={"group": "a"}, ts=2)
        um.event("run_state", "starting at 0", ts=3)   # third: a batch
        um.metric("x", 1, ts=4)
        um.flush()
        out[name] = ([lp.encode_point(p) for p in got], um.stats)
    assert out["port"] == out["jax"]


def test_usermetric_rebuffers_a_failing_sink():
    def dead(points):
        raise ConnectionError("down")
    um = tum.UserMetric(dead, hostname="h0", batch_size=2,
                        max_buffered_points=3)
    for i in range(4):
        um.metric("m", float(i), ts=i)     # implicit flushes never raise
    with pytest.raises(ConnectionError):
        um.flush()
    st_ = um.stats
    # three implicit flushes (at 2, 3 and 4 points) and the explicit one
    assert st_["failed_flushes"] == 4 and st_["buffered"] == 3
    assert st_["dropped_points"] == 1


def test_collect_step_matches_the_reference():
    consts = dict(hlo_flops=3e12, model_flops=2.5e12, tokens_per_step=128.0,
                  **H100)
    out = {}
    for name, mod, lp in (("jax", jagent, jlp), ("port", tagent, tlp)):
        got = []

        class Sink:
            def write(self, points):
                got.extend(points)
        agent = mod.HostAgent(Sink(), "h0", dict(consts), batch_size=2)
        derived = [agent.collect_step(step=s, step_time_s=0.05 * (s + 1),
                                      extra_events={"data_wait_s": 0.001},
                                      ts=s) for s in range(3)]
        agent.flush()
        out[name] = ([lp.encode_point(p) for p in got], derived)
    assert out["port"][0] == out["jax"][0]
    for tg, jg in zip(out["port"][1], out["jax"][1]):
        assert tg.keys() == jg.keys()
        for k in jg:
            assert math.isclose(tg[k], jg[k], rel_tol=1e-12)
    sysp = tagent.HostAgent(None, "h0").collect_system()
    assert sysp.measurement == "system" and sysp.tags == {"hostname": "h0"}
    assert set(jagent.HostAgent(None, "h0").collect_system().fields) == \
        set(sysp.fields)


# -- the job/stack split over HTTP --------------------------------------------


@pytest.fixture
def http_stack(tmp_path):
    st_ = MonitoringStack.inprocess(out_dir=str(tmp_path / "lms"),
                                    serve_http=True)
    try:
        yield st_
    finally:
        st_.close()


def _loop_run(stack, tmp_path, job_id):
    cfg = get_config("lms-demo", smoke=True)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, learning_rate=5e-3)
    losses = []
    r = tloop.train(cfg, tcfg, TINY, stack=stack, device="cpu",
                    job_id=job_id, step_callback=lambda s, m: losses.append(
                        float(m["loss"])), **PEAKS)
    return cfg, r, losses


def _db_view(db):
    return {"measurements": set(db.measurements()),
            "regions": set(db.tag_values("marker", "region")),
            "loss": db.select("train", ["loss"])[0].values["loss"],
            "events": [v for s in db.select("run_state")
                       for v in s.values["event"]]}


def test_loop_through_a_remote_stack(http_stack, tmp_path):
    remote = RemoteStack(http_stack.http.url)
    cfg, r, losses = _loop_run(remote, tmp_path, "rj")
    remote.close()
    assert r.steps_run == 4 and r.final_step == 4 and r.findings == []
    db = http_stack.backend.db("global")
    train_pts = db.select("train", ["loss", "grad_norm", "lr"])
    assert len(train_pts) == 1 and train_pts[0].tags["jobid"] == "rj"
    assert train_pts[0].values["loss"] == losses
    hpm = db.select("hpm", ["mfu", "step_time_s"])
    assert len(hpm) == 1 and hpm[0].tags["jobid"] == "rj"
    n_t = 6 * cfg.param_count() * TINY.global_batch * TINY.seq_len
    assert len(hpm[0].values["mfu"]) == 4
    for mfu, t in zip(hpm[0].values["mfu"], hpm[0].values["step_time_s"]):
        assert math.isclose(mfu, n_t / t / PEAKS["peak_flops"],
                            rel_tol=1e-12)
    markers = db.select("marker", None)
    regions = {s.tags["region"] for s in markers}
    assert {"data_wait", "train_step", tmarker.CALIB_REGION} <= regions
    assert all(s.tags.get("jobid") == "rj" for s in markers)
    calib = db.select("marker", ["peak_flops", "peak_bw"],
                      {"region": tmarker.CALIB_REGION})[0].values
    assert (calib["peak_flops"], calib["peak_bw"]) == \
        ([PEAKS["peak_flops"]], [PEAKS["hbm_bw"]])
    steps = sum(sum(s.values["calls"]) for s in markers
                if s.tags["region"] == "train_step")
    assert steps == 4
    job = http_stack.router.jobs.get("rj")
    assert job.end_ns is not None and not job.running   # /job/end closed it
    assert http_stack.router.jobs.running_jobs() == []
    st_ = remote.stats
    assert st_["posts"] >= 1 and st_["failed"] == 0
    assert st_["failed_flushes"] == 0 and st_["dropped_points"] == 0
    # every point the client posted was stored (beside the stack's own)
    assert st_["points"] == sum(
        len(s.times) for m in db.measurements() if m not in (
            "analysis", "job_event") for s in db.select(m))

    # the same run through the in-process stack lands the same series
    local = MonitoringStack.inprocess(out_dir=str(tmp_path / "local"))
    try:
        _, r2, losses2 = _loop_run(local, tmp_path, "rj")
        want = _db_view(local.backend.db("global"))
    finally:
        local.close()
    assert losses2 == losses
    assert (r2.steps_run, r2.final_step, r2.last_loss) == \
        (r.steps_run, r.final_step, r.last_loss)
    assert _db_view(db) == want


def test_calibration_point_places_port_kernels_on_the_given_roofline(
        http_stack):
    """A port run stores its device's peaks, and the stack's
    roofline of a ``kernel:*`` region reads them, not the reference chip's
    197 TFLOP/s and 819 GB/s."""
    pf, bw = 989e12, 3.35e12
    remote = RemoteStack(http_stack.http.url)
    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(0))
    scale = torch.ones(512)
    with remote.job("roof", user="u", hosts=["h0"]):
        um = remote.usermetric(host="h0")
        tmarker.calibrate(um, pf, bw)
        prev = ops.set_kernel_markers(um.markers)
        try:
            for _ in range(5):
                ops.fused_rmsnorm(x, scale)
        finally:
            ops.set_kernel_markers(prev)
    remote.close()
    db = http_stack.backend.db("global")
    assert jmarker.roofline_peaks(db) == (pf, bw)
    s = db.select("marker", ["flops", "bytes", "time_s", "calls"],
                  {"region": "kernel:rmsnorm", "jobid": "roof"})
    assert len(s) == 1
    tot = {k: sum(v) for k, v in s[0].values.items()}
    costs = rms.cost_estimate(x.shape, x.element_size())
    assert tot["calls"] == 5 and tot["flops"] == 5 * costs["flops"]
    want = tot["flops"] / tot["time_s"] / min(
        pf, bw * tot["flops"] / tot["bytes"])
    try:
        jmarker.register_roofline_group(*jmarker.roofline_peaks(db))
        res = QueryEngine(db).query(jmarker.roofline_spec(
            "roof", region="kernel:rmsnorm", window_ns=3600 * S))
    finally:
        jmarker.register_roofline_group()       # restore for other tests
    vals = res.groups["kernel:rmsnorm"]["roofline_frac"]["values"]
    got = [v for v in vals if v is not None]
    assert len(got) == 1 and math.isclose(got[0], want, rel_tol=1e-9)
    on_tpu = tot["flops"] / tot["time_s"] / min(
        197e12, 819e9 * tot["flops"] / tot["bytes"])
    assert not math.isclose(got[0], on_tpu, rel_tol=0.5)
    assert "PEAK_FLOPS" in dict(jmarker.roofline_spec().metrics)[
        "roofline_frac"]


def test_findings_come_back_through_alerts(http_stack, monkeypatch):
    monkeypatch.setattr(tcore, "POLL_INTERVAL_S", 3600.0)
    remote = RemoteStack(http_stack.http.url)
    seen = []
    remote.on_finding(seen.append)
    hosts = ["h0", "h1"]
    with remote.job("fj", user="u", hosts=hosts):
        agents = [remote.host_agent(h, hlo_flops=5e14, model_flops=4e14,
                                    tokens_per_step=1024, **H100)
                  for h in hosts]
        t0 = tlp.now_ns()
        for step in range(40):
            for a in agents:
                slow = a.hostname == "h1" and step > 10
                a.collect_step(step=step, step_time_s=5000.0 if slow
                               else 5.0, ts=t0 + step * 5 * S)
    found = remote.findings()
    assert any(f.rule == "compute_break" and f.host == "h1" for f in found)
    f = next(f for f in found if f.rule == "compute_break")
    assert f.duration_s > 60 and f.severity == "critical"
    new = remote.poll_findings()
    assert {(x.rule, x.host) for x in new} == {(x.rule, x.host)
                                               for x in found}
    assert seen == new
    assert remote.poll_findings() == []            # throttled
    assert remote.poll_findings(force=True) == []  # each reported once
    remote.close()


def _closed_port_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def test_unreachable_stack_raises_at_job_start():
    remote = RemoteStack(_closed_port_url())
    with pytest.raises(OSError):
        with remote.job("x"):
            pass
    with pytest.raises(OSError):
        remote.sink.ping()
    cfg = get_config("lms-demo", smoke=True)
    with pytest.raises(OSError):
        tloop.train(cfg, TrainConfig(total_steps=1), TINY, stack=remote,
                    device="cpu", **PEAKS)


def test_a_stack_that_goes_away_is_counted_then_raised(http_stack,
                                                       monkeypatch):
    """Mid-job, posts that fail are counted and re-buffered (the job goes
    on); the job's end raises."""
    monkeypatch.setattr(tcore, "BATCH_SIZE", 1)
    remote = RemoteStack(http_stack.http.url)
    with pytest.raises(OSError):
        with remote.job("gone", user="u"):
            um = remote.usermetric(host="h0")
            um.metric("m", 1.0)
            http_stack.http.stop()
            http_stack.http = None
            um.metric("m", 2.0)             # implicit flush: no raise
            assert remote.stats["failed_flushes"] == 1
            assert remote.poll_findings(force=True) == []
            assert remote.stats["poll_failures"] == 1
    assert um.stats["buffered"] == 1 and um.stats["sent_points"] == 1
    assert np.isfinite(remote.stats["seconds"])
