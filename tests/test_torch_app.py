"""The port's operator entry point (``firedancer_tpu_torch/app/``,
``utils/pod.py``, ``utils/pcap.py``, ``utils/pcapng.py``) and its
verify lanes against the JAX package's, on the CPU, at the sizes of the
JAX ``tests/test_app.py`` (txn_cnt 12, rings 64 deep, a 4 MiB
workspace).

* ``load_config``: the same TOMLs give the same config but for the
  verify backend (the port's "gpu" and "oracle"; "cpu" and "tpu" raise
  ``ConfigError``), the env var, the unknown-key and type errors and the
  int -> float widening alike.
* ``Pod``: the same inserts serialize to the same bytes, and each
  package reads the other's; ``configure init all`` at 1 and 3 verify
  lanes writes the JAX pod's keys and values, fd_flight's schema key
  among them.
* ``read_capture`` reads a JAX-written classic pcap and pcapng as the
  JAX package does; ``synth_payloads(device="cpu")`` and ``keygen`` give
  the JAX bytes.
* ``fdctl`` and ``fddev`` (``main(..., device="cpu")``, the gpu backend
  on CPU tensors) give the JAX CLI's sent, recv_cnt and summed SV and HA
  filters on the same TOML at 1 and 3 lanes, from the synthetic load
  and from a pcap; more than one lane runs the step loop and warns the
  JAX package's reason.
* ``run_pipeline(record_digests=True, feed=False)`` over three lanes
  delivers the JAX three-lane runner's sink multiset, every lane
  carrying traffic; ``MuxTile`` fans two links into one; ``render``
  gives the JAX text on one snapshot with the tick clocks pinned; the
  launch counters lose no count under threads.

The JAX side runs as its own tests run it: its "cpu" backend with the
native verifier. Idle tiles sleep 5 ms here (``_slow_idle``) instead of
``tiles.idle_pause``'s 1 ms: each wake takes the GIL from the verify
thread between its plain PyTorch ops, and the plain verify makes
thousands of them, so three lanes on the CPU ran 3-4x slower at 1 ms.
"""

import json
import logging
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from firedancer_tpu.app import config as jcfg
from firedancer_tpu.app import configure as jconfigure
from firedancer_tpu.app import fdctl as jfdctl
from firedancer_tpu.disco import monitor as jmonitor
from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.tango import tempo as jtempo
from firedancer_tpu.utils import pcap as jpcap
from firedancer_tpu.utils import pcapng as jpcapng
from firedancer_tpu.utils.pod import Pod as JPod
from firedancer_tpu_torch.app import config as pcfg
from firedancer_tpu_torch.app import configure as pconfigure
from firedancer_tpu_torch.app import ctl as pctl
from firedancer_tpu_torch.app import fdctl as pfdctl
from firedancer_tpu_torch.app import fddev as pfddev
from firedancer_tpu_torch.disco import corpus as pcorpus
from firedancer_tpu_torch.disco import monitor as pmonitor
from firedancer_tpu_torch.disco import pipeline as ppipe
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.ops import backend
from firedancer_tpu_torch.tango import rings as prings
from firedancer_tpu_torch.tango import tempo as ptempo
from firedancer_tpu_torch.utils import pcap as ppcap
from firedancer_tpu_torch.utils.pod import Pod as PPod

torch.set_num_threads(1)

LANE_REASON = "verify_lane_cnt={} (feed serves exactly 1 lane)"


@pytest.fixture(autouse=True)
def _slow_idle(monkeypatch):
    monkeypatch.setattr(ptiles, "idle_pause",
                        lambda spins: 0.0 if spins <= 64 else 5e-3)


def _cfg(mod, tmp_path, lanes=1, **synth):
    c = mod.load_config()
    c["scratch_directory"] = str(tmp_path)
    c["layout"]["depth"] = 64
    c["layout"]["wksp_sz"] = 1 << 22
    c["layout"]["verify_tile_count"] = lanes
    c["development"]["synth"]["txn_cnt"] = 12
    c["development"]["synth"].update(synth)
    return c


def _toml(path, scratch, lanes, txn_cnt=12, frac=0.25):
    """The CLI runs' TOML. It names no backend: the JAX default is its
    "cpu" backend, the port's the gpu backend (on CPU tensors here)."""
    path.write_text(
        f'scratch_directory = "{scratch}"\n'
        f"[layout]\ndepth = 64\nwksp_sz = 4194304\n"
        f"verify_tile_count = {lanes}\n"
        "[tiles.verify]\nbatch = 32\n"
        "[development]\ntimeout_s = 120.0\n"
        f"[development.synth]\ntxn_cnt = {txn_cnt}\n"
        f"dup_frac = {frac}\nbad_frac = {frac}\n")
    return str(path)


def _last_json(out: str) -> dict:
    return json.loads([l for l in out.splitlines() if l.startswith("{")][-1])


# -- config ------------------------------------------------------------------


def _without_backend(c):
    c = json.loads(json.dumps(c))
    c["tiles"]["verify"].pop("backend")
    return c


def test_config_defaults_match_jax_but_the_backend():
    assert pcfg.DEFAULTS["tiles"]["verify"]["backend"] == "gpu"
    assert _without_backend(pcfg.load_config()) == _without_backend(
        jcfg.load_config())
    assert pcfg.ENV_CONFIG == jcfg.ENV_CONFIG


@pytest.mark.parametrize("body", [
    'name = "x9"\n[layout]\nverify_tile_count = 4\ntile_cpus = [1, 2]\n'
    "[tiles.pack]\nbank_cnt = 2\n",
    '[tiles.verify]\nmode = "rlc"\nbatch = 8192\nmax_msg_len = 1232\n'
    "[development]\ntimeout_s = 5\n",
    '[development.synth]\ntxn_cnt = 3\ndup_frac = 0\nseed = 7\n'
    '[tiles.quic]\nidentity_seed_path = "/x/id.json"\nretry = true\n',
])
@pytest.mark.parametrize("backend_line", ["", 'backend = "oracle"\n'])
def test_config_toml_overrides_match_jax(tmp_path, monkeypatch, body,
                                         backend_line):
    """The same TOML through both loaders, by path and by the env var."""
    if "[tiles.verify]\n" in body:
        text = body.replace("[tiles.verify]\n",
                            "[tiles.verify]\n" + backend_line)
    else:
        text = body + ("[tiles.verify]\n" + backend_line
                       if backend_line else "")
    toml = tmp_path / "op.toml"
    toml.write_text(text)
    got, want = pcfg.load_config(str(toml)), jcfg.load_config(str(toml))
    assert _without_backend(got) == _without_backend(want)
    assert got["tiles"]["verify"]["backend"] == (
        "oracle" if backend_line else "gpu")
    monkeypatch.setenv(pcfg.ENV_CONFIG, str(toml))
    assert pcfg.load_config() == got
    assert _without_backend(jcfg.load_config()) == _without_backend(got)


@pytest.mark.parametrize("body", [
    "[layout]\nnot_a_knob = 1\n",
    "[layout]\ndepth = true\n",
    "name = 42\n",
    '[tiles]\nverify = "gpu"\n',
    "[development.synth]\nseed = 1.5\n",
    "[layout\n",
])
def test_config_errors_match_jax(tmp_path, body):
    toml = tmp_path / "bad.toml"
    toml.write_text(body)
    with pytest.raises(jcfg.ConfigError) as jerr:
        jcfg.load_config(str(toml))
    with pytest.raises(pcfg.ConfigError) as perr:
        pcfg.load_config(str(toml))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["cpu", "tpu", "cuda"])
def test_config_refuses_backends_the_port_lacks(tmp_path, name):
    toml = tmp_path / "b.toml"
    toml.write_text(f'[tiles.verify]\nbackend = "{name}"\n')
    with pytest.raises(pcfg.ConfigError, match="'gpu' or 'oracle'"):
        pcfg.load_config(str(toml))
    if name != "cuda":
        assert jcfg.load_config(str(toml))["tiles"]["verify"]["backend"] \
            == name


# -- pod ---------------------------------------------------------------------


def _inserts(seed):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(40):
        path = ".".join(f"k{int(rng.randint(0, 4))}"
                        for _ in range(int(rng.randint(1, 4)))) + f".v{i}"
        kind = i % 3
        val = (int(rng.randint(0, 2**62)) * 3 if kind == 0
               else f"s{i}-é" if kind == 1
               else rng.randint(0, 256, int(rng.randint(0, 40)),
                                dtype=np.uint8).tobytes())
        out.append((path, val))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pod_bytes_equal_jax(seed):
    p, j = PPod(), JPod()
    for path, val in _inserts(seed):
        p.insert(path, val)
        j.insert(path, val)
    p.insert_ulong("firedancer.mtu", 1232).insert_cstr("a.b", "c")
    j.insert_ulong("firedancer.mtu", 1232).insert_cstr("a.b", "c")
    blob = p.serialize()
    assert blob == j.serialize()
    assert PPod.deserialize(j.serialize()).to_dict() == j.to_dict()
    assert JPod.deserialize(blob).to_dict() == p.to_dict()
    assert list(PPod.deserialize(blob).iter_leaves()) == list(
        j.iter_leaves())


@pytest.mark.parametrize("lanes", [1, 3])
def test_pod_keys_after_configure_init_all(tmp_path, lanes):
    pc = _cfg(pcfg, tmp_path / "p", lanes)
    jc = _cfg(jcfg, tmp_path / "j", lanes)
    pconfigure.configure_cmd("init", pc, None, log=lambda m: None)
    jconfigure.configure_cmd("init", jc, None, log=lambda m: None)
    try:
        with open(pcfg.pod_path(pc), "rb") as f:
            ppod = dict(PPod.deserialize(f.read()).iter_leaves())
        with open(jcfg.pod_path(jc), "rb") as f:
            jpod = dict(JPod.deserialize(f.read()).iter_leaves())
        assert "firedancer.flight.schema" in ppod
        assert ppod == jpod
        assert ppod["firedancer.layout.verify_lane_cnt"] == lanes
        assert (f"firedancer.replay_verify.v{lanes - 1}.mcache" in ppod) \
            == (lanes > 1)
        assert pconfigure.configure_cmd("check", pc, None,
                                        log=lambda m: None)
        # A layout edit makes the workspace stage stale.
        pc["layout"]["verify_tile_count"] = lanes + 1
        assert not pconfigure.configure_cmd("check", pc, ["workspace"],
                                            log=lambda m: None)
    finally:
        pconfigure.configure_cmd("fini", pc, None, log=lambda m: None)
        jconfigure.configure_cmd("fini", jc, None, log=lambda m: None)
    assert not os.path.exists(pc["scratch_directory"])


def test_build_topology_counts_every_lanes_dcaches(tmp_path):
    need = 8 * ppipe.dcache_size(64)
    with pytest.raises(ValueError, match="8 links"):
        ppipe.build_topology(str(tmp_path / "t.wksp"), depth=64,
                             wksp_sz=need - 64, verify_lanes=3)
    with pytest.raises(ValueError, match="at least 1"):
        ppipe.build_topology(str(tmp_path / "z.wksp"), verify_lanes=0)
    topo = ppipe.build_topology(str(tmp_path / "t.wksp"), depth=64,
                                wksp_sz=need + (1 << 20), verify_lanes=3)
    assert topo.verify_lanes == 3
    assert ppipe.Topology(topo.wksp_path).verify_lanes == 1


# -- pcap, synth, keygen -----------------------------------------------------


def test_read_capture_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    payloads = [rng.randint(0, 256, int(rng.randint(0, 1300)),
                            dtype=np.uint8).tobytes() for _ in range(25)]
    classic, ng = str(tmp_path / "c.pcap"), str(tmp_path / "c.pcapng")
    with jpcap.PcapWriter(classic) as w:
        for i, pl in enumerate(payloads):
            w.write(pl, ts_sec=i, ts_usec=7 * i)
    with jpcapng.PcapngWriter(ng, if_name="lo") as w:
        for i, pl in enumerate(payloads):
            if i % 3 == 2:
                w.write_simple(pl)
            else:
                w.write(pl, ts_ns=1_000_003 * i)
            if i == 10:
                w.write_tls_keys(b"CLIENT_RANDOM 00 11\n")
    for path in (classic, ng):
        got = ppcap.read_capture(path)
        assert got == jpcap.read_capture(path) == payloads
    ported = str(tmp_path / "p.pcap")
    with ppcap.PcapWriter(ported) as w:
        for i, pl in enumerate(payloads):
            w.write(pl, ts_sec=i, ts_usec=7 * i)
    assert open(ported, "rb").read() == open(classic, "rb").read()


@pytest.mark.parametrize("frac", [None, 0.25])
def test_synth_payloads_equal_jax(tmp_path, frac):
    kw = {} if frac is None else {"dup_frac": frac, "bad_frac": frac}
    got = pfdctl.synth_payloads(_cfg(pcfg, tmp_path, **kw), device="cpu")
    want = jfdctl.synth_payloads(_cfg(jcfg, tmp_path, **kw))
    assert len(got) == 12 + 2 * int(12 * (frac or 0.1))
    assert got == want


def test_keygen_equals_jax(tmp_path):
    seed = bytes(range(7, 39))
    pp, jp = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    assert pconfigure.keygen(pp, seed=seed) == jconfigure.keygen(jp, seed=seed)
    assert open(pp).read() == open(jp).read()
    assert oct(os.stat(pp).st_mode & 0o777) == "0o600"
    assert pconfigure.read_keypair(jp) == jconfigure.read_keypair(pp)
    raw = json.load(open(pp))
    raw[40] ^= 0xFF
    json.dump(raw, open(pp, "w"))
    with pytest.raises(ValueError, match="does not match"):
        pconfigure.read_keypair(pp)


def test_fdctl_keygen_and_security(tmp_path, capsys):
    out = str(tmp_path / "k" / "id.json")
    assert pfdctl.main(["keygen", "--out", out]) == 0
    seed, pub = pconfigure.read_keypair(out)
    assert pub.hex() in capsys.readouterr().out
    assert pfdctl.main(["security", "--json"]) == 0
    reqs = json.loads(capsys.readouterr().out)
    assert {"memlock", "nofile", "userns"} <= {r["name"] for r in reqs}


# -- the CLI runs ------------------------------------------------------------


def _cli_counts(res: dict) -> tuple:
    return (res["sent"], res["recv_cnt"],
            res["verify_sv_filt"] + res["verify_ha_filt"])


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's results by (lanes, source) on the CLI runs' TOML:
    configure, run synth, run pcap, fini."""
    out = {}
    d = tmp_path_factory.mktemp("jcli")
    pcap = str(d / "txs.pcap")
    with pytest.MonkeyPatch.context() as mp:
        # The JAX feed's layout knob: no worker processes to boot.
        mp.setenv("FD_FEED_PROC", "0")
        _jax_cli_runs(d, pcap, out)
    return out, pcap


def _jax_cli_runs(d, pcap, out):
    import contextlib
    import io

    for lanes in (1, 3):
        toml = _toml(d / f"j{lanes}.toml", d / f"s{lanes}", lanes)
        with jpcap.PcapWriter(pcap) as w:
            for pl in jfdctl.synth_payloads(jcfg.load_config(toml))[:8]:
                w.write(pl)
        # A fresh workspace a run: a second run on one workspace starts
        # its cursors where the first ended, in both packages.
        for source, args in (
                ("synth", ["run"]),
                ("pcap", ["run", "--source", "pcap", "--pcap", pcap])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                for argv in (["configure", "init", "all"], args,
                             ["configure", "fini", "all"]):
                    assert jfdctl.main(["--config", toml, *argv]) == 0
            out[(lanes, source)] = _last_json(buf.getvalue())


@pytest.mark.parametrize("lanes", [1, 3])
def test_fdctl_synth_sequence_matches_jax(jax_cli, tmp_path, capsys, caplog,
                                          lanes):
    toml = _toml(tmp_path / "p.toml", tmp_path / "s", lanes)
    main = pfdctl.main
    assert main(["--config", toml, "configure", "init", "all"],
                device="cpu") == 0
    with caplog.at_level(logging.WARNING):
        assert main(["--config", toml, "run"], device="cpu") == 0
    res = _last_json(capsys.readouterr().out)
    want = jax_cli[0][(lanes, "synth")]
    assert _cli_counts(res) == _cli_counts(want)
    assert (res["sent"], res["recv_cnt"]) == (18, 12)
    assert res["bank_hist"] == want["bank_hist"]
    warned = LANE_REASON.format(lanes) in caplog.text
    assert warned == (lanes > 1)
    assert main(["--config", toml, "monitor", "--once", "--no-ansi"],
                device="cpu") == 0
    mon = capsys.readouterr().out
    for i in range(lanes):
        v = ppipe.lane_link("verify", i)
        assert f"\n{v} " in mon and f"\nreplay_{v} " in mon
    assert main(["--config", toml, "configure", "fini", "all"],
                device="cpu") == 0
    assert not os.path.exists(str(tmp_path / "s"))


@pytest.mark.parametrize("lanes", [1, 3])
def test_fdctl_pcap_run_matches_jax(jax_cli, tmp_path, capsys, lanes):
    toml = _toml(tmp_path / "p.toml", tmp_path / "s", lanes)
    results, pcap = jax_cli
    main = pfdctl.main
    assert main(["--config", toml, "configure", "init", "all"],
                device="cpu") == 0
    try:
        assert main(["--config", toml, "run", "--source", "pcap",
                     "--pcap", pcap], device="cpu") == 0
        res = _last_json(capsys.readouterr().out)
    finally:
        main(["--config", toml, "configure", "fini", "all"], device="cpu")
    assert _cli_counts(res) == _cli_counts(results[(lanes, "pcap")])
    assert (res["sent"], res["recv_cnt"]) == (8, 8)


def test_fdctl_run_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toml = _toml(tmp_path / "p.toml", tmp_path / "s", 1)
    assert pfdctl.main(["--config", toml, "configure", "init", "all"]) == 0
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pfdctl.main(["--config", toml, "run"])
    finally:
        pfdctl.main(["--config", toml, "configure", "fini", "all"])


def _record_pins(monkeypatch):
    """os.sched_setaffinity recorded by thread name, not applied."""
    pins = {}
    monkeypatch.setattr(os, "sched_setaffinity", lambda pid, cpus: pins.update(
        {threading.current_thread().name: sorted(cpus)}))
    return pins


def test_fddev_dev_cleans_up(tmp_path, capsys, monkeypatch):
    """fddev dev on the oracle backend (the host oracle verifies; the
    step loop runs, as the feed needs the gpu backend), its tiles pinned
    by [layout] tile_cpus in topology order."""
    toml = _toml(tmp_path / "d.toml", tmp_path / "s", 1, txn_cnt=6, frac=0.0)
    with open(toml) as f:
        text = f.read().replace("batch = 32\n",
                                'batch = 32\nbackend = "oracle"\n')
    with open(toml, "w") as f:
        f.write(text.replace("[layout]\n", "[layout]\ntile_cpus = [4, 5]\n"))
    pins = _record_pins(monkeypatch)
    assert pfddev.main(["--config", toml, "dev"], device="cpu") == 0
    assert _last_json(capsys.readouterr().out)["recv_cnt"] == 6
    assert not os.path.exists(str(tmp_path / "s"))
    assert pins == {"replay": [4], "verify": [5], "dedup": [4], "pack": [5],
                    "sink": [4]}


def test_feed_pins_its_tiles(tmp_path, monkeypatch):
    """tile_cpus through the feed: its threads here, and a worker's
    tiles by the cpu_map option."""
    from firedancer_tpu_torch.disco import worker as pworker

    payloads = pfdctl.synth_payloads(_cfg(pcfg, tmp_path, txn_cnt=4),
                                     device="cpu")
    topo = ppipe.build_topology(str(tmp_path / "f.wksp"), depth=64)
    pins = _record_pins(monkeypatch)
    res = ppipe.run_pipeline(topo, payloads, verify_batch=32, device="cpu",
                             feed_proc=False, tile_cpus=[1, 2, 3],
                             timeout_s=60.0)
    assert res.feed and res.recv_cnt == 4
    assert pins == {"replay": [1], "verify": [2], "dedup": [3], "pack": [1],
                    "sink": [2]}
    w = prings.Workspace.join(topo.wksp_path)
    tile = pworker.build_tile(w, "sink", {"cpu_map": {"sink": 6, "pack": 7}})
    assert tile.cpu_idx == 6
    assert pworker.build_tile(w, "pack", {}).cpu_idx is None
    w.leave()


def test_ctl_reads_the_workspace_and_pod(tmp_path, capsys):
    cfg = _cfg(pcfg, tmp_path / "s", 2)
    pconfigure.configure_cmd("init", cfg, None, log=lambda m: None)
    wk, pod = pcfg.wksp_path(cfg), pcfg.pod_path(cfg)
    try:
        def run(*argv):
            rc = pctl.main(list(argv))
            return rc, json.loads(capsys.readouterr().out)

        rc, usage = run("wksp", "usage", wk)
        rc2, allocs = run("wksp", "list", wk)
        names = {a["name"] for a in allocs}
        assert rc == rc2 == 0 and usage["alloc_cnt"] == len(allocs)
        assert {"replay_verify.v1.mcache", "verify.v1.cnc"} <= names
        assert run("wksp", "query", wk, "nope")[0] == 1
        rc, keys = run("pod", "list", pod, "firedancer.verify.")
        assert keys == {"firedancer.verify.cnc": "verify.cnc",
                        "firedancer.verify.v1.cnc": "verify.v1.cnc"}
        assert run("pod", "query", pod, "firedancer.layout.verify_lane_cnt"
                   )[1] == {"firedancer.layout.verify_lane_cnt": 2}
        assert run("tango", "mcache", wk, "verify_dedup.v1.mcache")[1] == {
            "name": "verify_dedup.v1.mcache", "depth": 64, "seq_next": 0}
        assert run("tango", "cnc", wk, "pack.cnc")[1]["signal"] == "boot"
        assert run("tango", "fseq", wk, "pack_sink.fseq")[1]["seq"] == 0
    finally:
        pconfigure.configure_cmd("fini", cfg, None, log=lambda m: None)


# -- lanes, mux, render ------------------------------------------------------


@pytest.fixture(scope="module")
def lane_corpus():
    return pcorpus.mainnet_corpus(n=12, seed=5, dup_rate=0.25,
                                  corrupt_rate=0.25, parse_err_rate=0.17,
                                  device="cpu")


def test_three_lane_sink_equals_jax(lane_corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("FD_FEED", "0")
    jtopo = jpipe.build_topology(str(tmp_path / "j.wksp"), depth=64,
                                 wksp_sz=1 << 23, verify_lanes=3)
    jres = jpipe.run_pipeline(jtopo, lane_corpus.payloads,
                              verify_backend="cpu", verify_batch=32,
                              record_digests=True, timeout_s=120.0)
    topo = ppipe.build_topology(str(tmp_path / "p.wksp"), depth=64,
                                verify_lanes=3)
    backend.reset_counts()
    res = ppipe.run_pipeline(topo, lane_corpus.payloads, verify_batch=32,
                             record_digests=True, device="cpu",
                             timeout_s=120.0, feed=False)
    assert Counter(res.sink_digests) == Counter(jres.sink_digests) == \
        pcorpus.expected_sink_digests(lane_corpus)
    assert res.feed_fallback_reason is None and len(res.verify_stats) == 3
    n = len(lane_corpus.payloads)
    for i, vs in enumerate(res.verify_stats):
        link = f"link.{ppipe.lane_link('replay_verify', i)}"
        assert res.diag[link]["tx_seq"] == jres.diag[link]["tx_seq"] == \
            len(range(i, n, 3))
        assert vs["batches"] >= 1
        tile = f"tile.{ppipe.lane_link('verify', i)}"
        for k in ("ha_filt_cnt", "sv_filt_cnt"):
            assert res.diag[tile][k] == jres.diag[tile][k], (tile, k)
    filt = sum(res.diag[f"tile.{ppipe.lane_link('verify', i)}"][k]
               for i in range(3) for k in ("ha_filt_cnt", "sv_filt_cnt"))
    filt += sum(res.diag[f"link.{k}"]["filt_cnt"] for k in (
        "verify_dedup", "verify_dedup.v1", "verify_dedup.v2", "dedup_pack"))
    assert filt + res.recv_cnt == n
    assert set(res.tile_cpu_s) == {"replay", "verify", "verify.v1",
                                   "verify.v2", "dedup", "pack", "sink"}
    # Each lane's batches ran the plain versions (CPU tensors).
    lanes = sum(vs["batches"] for vs in res.verify_stats)
    assert backend.plain_calls["point_eq"] == lanes
    assert 0 < res.latency_p50_ns <= res.latency_p99_ns


def test_step_loop_feed_reason_for_lanes(lane_corpus, tmp_path, caplog):
    """run_pipeline's default asks for the feed; two lanes keep the step
    loop, warn the JAX reason and record it."""
    topo = ppipe.build_topology(str(tmp_path / "p.wksp"), depth=64,
                                verify_lanes=2)
    with caplog.at_level(logging.WARNING):
        res = ppipe.run_pipeline(topo, lane_corpus.payloads[:4],
                                 verify_backend="oracle", device="cpu",
                                 timeout_s=60.0)
    assert not res.feed
    assert res.feed_fallback_reason == "verify backend 'oracle' (the feed " \
        "needs gpu)"
    assert ppipe._feed_fallback_reason("gpu", 32, None, 2) == \
        LANE_REASON.format(2)
    assert ppipe._feed_fallback_reason("gpu", 32, None, 1) is None
    assert "the feed needs gpu" in caplog.text
    assert len(res.verify_stats) == 2


def test_mux_tile_fan_in(tmp_path):
    """tests/test_pipeline.py:151's fan-in on the port: two replay
    sources, one MuxTile, one sink."""
    path = str(tmp_path / "mux.wksp")
    wksp = prings.Workspace.create(path, 1 << 23)
    for name in ("in0", "in1", "out"):
        prings.MCache(wksp, f"{name}.mcache", depth=64, create=True)
        prings.DCache(wksp, f"{name}.dcache", data_sz=64 * 20 * 66,
                      create=True)
        prings.FSeq(wksp, f"{name}.fseq", create=True)
    for tile in ("src0", "src1", "mux", "sink"):
        prings.Cnc(wksp, f"{tile}.cnc", create=True)

    pl_a = [b"a%03d" % i for i in range(40)]
    pl_b = [b"b%03d" % i for i in range(40)]
    src0 = ptiles.ReplayTile(wksp, "src0.cnc", ppipe.out_link(wksp, "in0"),
                             payloads=pl_a)
    src1 = ptiles.ReplayTile(wksp, "src1.cnc", ppipe.out_link(wksp, "in1"),
                             payloads=pl_b)
    mux = ptiles.MuxTile(wksp, "mux.cnc",
                         in_links=[ppipe.in_link(wksp, "in0"),
                                   ppipe.in_link(wksp, "in1")],
                         out_link=ppipe.out_link(wksp, "out"))
    sink = ptiles.SinkTile(wksp, "sink.cnc", ppipe.in_link(wksp, "out"),
                           record_digests=True)
    tiles = [src0, src1, mux, sink]
    threads = [threading.Thread(target=t.run, args=(30_000_000_000,),
                                daemon=True) for t in tiles]
    for th in threads:
        th.start()
    deadline = time.time() + 20
    while time.time() < deadline and sink.recv_cnt < 80:
        time.sleep(0.01)
    for t in tiles:
        t.cnc.signal(prings.CNC_HALT)
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert sink.recv_cnt == 80
    # Each source's frags in order, its tsorig kept.
    assert sorted(sink.recv_tsorig) == sorted(
        t & 0xFFFFFFFF for t in src0.pub_ticks + src1.pub_ticks)
    wksp.leave()


def test_replay_round_robin(tmp_path):
    topo = ppipe.build_topology(str(tmp_path / "r.wksp"), depth=64,
                                verify_lanes=3)
    w = prings.Workspace.join(topo.wksp_path)
    payloads = [bytes([i]) * (10 + i) for i in range(10)]
    replay = ppipe.build_tile(w, "replay", payloads=payloads, lanes=3)
    while not replay.done():
        replay.step()
    for lane in range(3):
        name = ppipe.lane_link("replay_verify", lane)
        mc, dc = prings.MCache(w, f"{name}.mcache"), prings.DCache(
            w, f"{name}.dcache")
        got = [dc.read(f.chunk, f.sz) for f in
               (mc.poll(s)[1] for s in range(mc.seq_next()))]
        assert got == payloads[lane::3]
    with pytest.raises(ValueError, match="exactly one"):
        ptiles.ReplayTile(w, "replay.cnc")
    w.leave()


def _snap():
    tile = {"signal": 1, "heartbeat": 10**12 - 2_500_000, "in_backp": 0,
            "backp_cnt": 3, "ha_filt_cnt": 2, "ha_filt_sz": 99,
            "sv_filt_cnt": 5, "sv_filt_sz": 700}
    link = {"seq": 40, "pub_cnt": 44, "pub_sz": 9000, "filt_cnt": 1,
            "filt_sz": 12, "ovrnp_cnt": 0, "ovrnr_cnt": 2, "slow_cnt": 0,
            "tx_seq": 45}
    snap = {f"tile.{t}": dict(tile, signal=i % 4)
            for i, t in enumerate(ppipe.topology_tiles(3))}
    snap["tile.quic"]["heartbeat"] = 0
    snap["tile.verify.v1"].update(feed_batches=4, feed_lanes=100,
                                  feed_idle_ns=5_000_000)
    snap.update({f"link.{k}": dict(link, pub_cnt=44 + i)
                 for i, k in enumerate(ppipe.topology_links(3))})
    prev = {k: dict(v, pub_cnt=v.get("pub_cnt", 0) // 2,
                    pub_sz=v.get("pub_sz", 0) // 3) for k, v in snap.items()}
    return snap, prev


@pytest.mark.parametrize("ansi", [True, False])
def test_render_equals_jax(monkeypatch, ansi):
    monkeypatch.setattr(jtempo, "tickcount", lambda: 10**12)
    monkeypatch.setattr(ptempo, "tickcount", lambda: 10**12)
    snap, prev = _snap()
    for p, dt in ((None, 1.0), (prev, 0.25)):
        got = pmonitor.render(snap, p, dt, ansi=ansi)
        assert got == jmonitor.render(snap, p, dt, ansi=ansi)
    assert "verify.v2" in got and "FEEDER" in got


def test_pod_snapshot_names_every_lane(tmp_path):
    topo = ppipe.build_topology(str(tmp_path / "s.wksp"), depth=64,
                                verify_lanes=3)
    w = prings.Workspace.join(topo.wksp_path)
    by_pod = pmonitor.snapshot(w, topo.pod)
    by_name = pmonitor.snapshot(w, ppipe.topology_tiles(3),
                                ppipe.topology_links(3))
    w.leave()
    assert by_pod == by_name
    assert {"tile.verify.v2", "link.replay_verify.v2",
            "link.verify_dedup.v1"} <= set(by_pod)


def test_launch_counts_lose_nothing_under_threads():
    """count_launch from eight threads at a 10 us switch interval: every
    count lands."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        backend.reset_counts()

        def hammer():
            for _ in range(5000):
                backend.count_launch("k")
                backend.count_plain("p")

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert backend.launches == {"k": 40000}
        assert backend.plain_calls == {"p": 40000}
    finally:
        sys.setswitchinterval(old)
        backend.reset_counts()
