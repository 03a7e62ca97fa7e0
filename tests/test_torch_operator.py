"""The port's operator (``services/operator.py``, ``deploy operator``)
against the JAX package's: ``tests/test_operator.py``'s reconciler cases
(crash restarts with backoff, scale up and down, spec updates, stop with
terminate-and-reap) over sleeper processes, ``specs_from_config`` equal
to the JAX one, and one ``deploy operator`` process on the CPU with the
default spec: it starts a broker, a PEM and a Kelvin that answer a query,
restarts the PEM after a SIGKILL, and leaves no child when stopped. The
opt-in soak (``PIXIE_TPU_SOAK=1``) is ``tests/test_soak.py``'s scenario
on the port's roles.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from pixie_tpu.services.operator import RoleSpec as JaxRoleSpec
from pixie_tpu.services.operator import specs_from_config as jax_specs
from pixie_tpu_torch.services import Reconciler, RoleSpec, specs_from_config

REPO = Path(__file__).resolve().parent.parent

#: A role whose process just sleeps: cheap and killable.
SLEEPER = (sys.executable, "-c", "import time; time.sleep(60)")


def _specs(**replicas):
    return {r: RoleSpec(name=r, replicas=n, command=SLEEPER)
            for r, n in replicas.items()}


def _alive(rec, role=None):
    return [s for s in rec.status()
            if s["alive"] and (role is None or s["role"] == role)]


def _gone(pid: int) -> bool:
    return subprocess.run(["kill", "-0", str(pid)],
                          capture_output=True).returncode != 0


def _wait(pred, timeout_s: float = 5.0, step: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(step)
    return True


class TestReconciler:
    def test_converges_to_desired_replicas(self):
        rec = Reconciler(_specs(pem=3, kelvin=1), base_backoff_s=0.01)
        try:
            rec.reconcile()
            assert len(_alive(rec, "pem")) == 3
            assert len(_alive(rec, "kelvin")) == 1
            assert [e[1] for e in rec.events].count("started") == 4
        finally:
            rec.stop()

    def test_crash_restarts_with_backoff(self):
        rec = Reconciler(_specs(pem=1), base_backoff_s=0.05,
                         max_backoff_s=0.05)
        try:
            rec.reconcile()
            (st,) = _alive(rec, "pem")
            os.kill(st["pid"], signal.SIGKILL)

            def restarted():
                rec.reconcile()
                alive = _alive(rec, "pem")
                return bool(alive) and alive[0]["pid"] != st["pid"]

            assert _wait(restarted)
            (st2,) = _alive(rec, "pem")
            assert st2["restarts"] >= 1
            assert st2["last_exit"] == -signal.SIGKILL
            assert "crashed" in [e[1] for e in rec.events]
            assert "restarted" in [e[1] for e in rec.events]
        finally:
            rec.stop()

    def test_backoff_doubles_and_caps(self):
        """Each restart doubles the wait from the last spawn, up to
        ``max_backoff_s``; a role that crashes inside it is respawned
        only when it has passed."""
        rec = Reconciler(_specs(pem=1), base_backoff_s=0.5,
                         max_backoff_s=1.0)
        try:
            rec.reconcile()
            ladder = []
            for _ in range(3):
                inst = rec._instances[("pem", 0)]
                ladder.append(round(inst.backoff_until - inst.started_at, 6))
                (st,) = _alive(rec, "pem")
                os.kill(st["pid"], signal.SIGKILL)
                assert _wait(lambda: _gone_or_zombie(st["pid"]))
                rec.reconcile()  # records the crash
                if time.monotonic() < inst.backoff_until:
                    assert not _alive(rec, "pem")

                def respawned():
                    rec.reconcile()
                    return bool(_alive(rec, "pem"))

                assert _wait(respawned, step=0.01)
                assert time.monotonic() >= inst.backoff_until - 1.0
            assert ladder == [0.5, 1.0, 1.0]
            assert rec.status()[0]["restarts"] == 3
        finally:
            rec.stop()

    def test_scale_down_terminates_extras(self):
        rec = Reconciler(_specs(pem=3), base_backoff_s=0.01)
        try:
            rec.reconcile()
            assert len(_alive(rec, "pem")) == 3
            rec.apply(_specs(pem=1))
            rec.reconcile()
            assert _wait(lambda: len(_alive(rec, "pem")) == 1)
            assert [e[1] for e in rec.events].count("terminated") == 2
            # The highest indices went first.
            assert [s["replica"] for s in rec.status()] == [0]
        finally:
            rec.stop()

    def test_role_removal_and_addition(self):
        rec = Reconciler(_specs(pem=1), base_backoff_s=0.01)
        try:
            rec.reconcile()
            rec.apply(_specs(kelvin=2))
            rec.reconcile()
            assert len(_alive(rec, "kelvin")) == 2
            assert _wait(lambda: not _alive(rec, "pem"))
        finally:
            rec.stop()

    def test_stop_terminates_children(self):
        rec = Reconciler(_specs(pem=2), base_backoff_s=0.01)
        rec.run_as_thread()
        assert _wait(lambda: len(_alive(rec)) == 2)
        pids = [s["pid"] for s in _alive(rec)]
        rec.stop()
        # Reaped, not zombies: kill -0 fails at once.
        assert all(_gone(p) for p in pids)
        assert not rec._thread.is_alive()


def _gone_or_zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


class TestSpecsFromConfig:
    CFG = {
        "pem": 3,
        "broker": {"replicas": 1, "env": {"PIXIE_TPU_NETBUS_PORT": 6100}},
        "custom": {"replicas": 2, "command": ["sleep", "1"]},
        "kelvin": {},
    }

    def test_shapes(self):
        specs = specs_from_config(self.CFG)
        assert specs["pem"].replicas == 3
        assert specs["pem"].command is None  # the deploy-role entry point
        assert dict(specs["broker"].env) == {"PIXIE_TPU_NETBUS_PORT": "6100"}
        assert specs["custom"].argv() == ["sleep", "1"]
        assert specs["pem"].argv() == [
            sys.executable, "-m", "pixie_tpu_torch.deploy", "pem"]

    def test_equal_to_jax(self):
        got, want = specs_from_config(self.CFG), jax_specs(self.CFG)
        assert list(got) == list(want)
        for role in got:
            g, w = got[role], want[role]
            assert (g.name, g.replicas, g.command, g.env) == (
                w.name, w.replicas, w.command, w.env)
            # Only the default entry point differs: each package's own.
            if g.command is None:
                assert g.argv()[:2] == w.argv()[:2]
                assert (g.argv()[2], w.argv()[2]) == (
                    "pixie_tpu_torch.deploy", "pixie_tpu.deploy")
        assert isinstance(want["pem"], JaxRoleSpec)

    @pytest.mark.parametrize("cfg,match", [
        ({"pem": None}, "must map to an int"),
        ({"pem": True}, "must map to an int"),
        ({"pem": {"replicas": "x"}}, "replicas must be an int"),
    ])
    def test_malformed_like_jax(self, cfg, match):
        with pytest.raises(ValueError, match=match) as got:
            specs_from_config(cfg)
        with pytest.raises(ValueError) as want:
            jax_specs(cfg)
        assert str(got.value) == str(want.value)

    def test_spawn_failure_backs_off_and_records(self):
        rec = Reconciler(
            {"bad": RoleSpec("bad", replicas=1,
                             command=("/no/such/binary-xyz",))},
            base_backoff_s=10.0,
        )
        try:
            rec.reconcile()
            rec.reconcile()  # inside the backoff: no hot retry
            assert [e[1] for e in rec.events].count("spawn_failed") == 1
            (st,) = rec.status()
            assert not st["alive"] and st["restarts"] == 1
        finally:
            rec.stop()


def test_children_inherit_the_device_but_not_the_spec(monkeypatch, tmp_path):
    out = tmp_path / "env.txt"
    probe = (sys.executable, "-c",
             "import os, sys; open(sys.argv[1], 'w').write(repr(("
             "os.environ.get('PIXIE_TPU_TORCH_DEVICE'), "
             "os.environ.get('PIXIE_TPU_OPERATOR_SPEC'), "
             "os.environ.get('PIXIE_TPU_REPLICA_INDEX'))))", str(out))
    monkeypatch.setenv("PIXIE_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PIXIE_TPU_OPERATOR_SPEC", "/nonexistent.yaml")
    rec = Reconciler({"probe": RoleSpec("probe", command=probe)})
    try:
        rec.reconcile()
        assert _wait(lambda: out.exists() and out.read_text())
        assert out.read_text() == repr(("cpu", None, "0"))
    finally:
        rec.stop()


# -- deploy operator ----------------------------------------------------------

SEQ_QUERY = (
    "import px\n"
    "df = px.DataFrame(table='sequences')\n"
    "df = df[df.x < 64]\n"
    "s = df.groupby('modulo10').agg(n=('x', px.count))\n"
    "px.display(s)\n"
)


def _free_port() -> int:
    """A free port below the kernel's ephemeral range. The roles bind it
    seconds after this returns; a port from ``bind(0)`` lies in that
    range, where any test's outgoing connection may take it meanwhile."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = np.random.default_rng()
    for _ in range(200):
        port = int(rng.integers(max(1024, low - 12000), low))
        s = socket.socket()
        try:
            s.bind(("0.0.0.0", port))
            return port
        except OSError:
            continue
        finally:
            s.close()
    raise RuntimeError("no free port below the ephemeral range")


def _children(pid: int) -> dict:
    """{child pid: its argv's role} of the live (not zombie) children."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out[int(d)] = argv[-2].decode() if len(argv) >= 2 else ""
    return out


def test_deploy_operator_default_spec_restarts_a_killed_pem(tmp_path):
    """``python -m pixie_tpu_torch.deploy operator`` on the CPU with the
    default spec (no YAML): its broker, PEM and Kelvin answer the
    sequences group-by; the PEM SIGKILLed comes back within the backoff
    and the query answers again; SIGTERM to the operator leaves no child.
    The whole test has a 100 s deadline."""
    from pixie_tpu_torch.api import Client

    deadline = time.monotonic() + 100.0
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PIXIE_TPU_OPERATOR_SPEC")}
    env.update(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
        PIXIE_TPU_TORCH_DEVICE="cpu", PIXIE_TPU_NETBUS_PORT=str(port),
        PIXIE_TPU_OBS_PORT="0", PIXIE_TPU_BROKER=f"127.0.0.1:{port}",
        PIXIE_TPU_SEQGEN="1", PIXIE_TPU_SELF_PROFILING="0",
    )
    log = open(tmp_path / "operator.log", "w+")
    op = subprocess.Popen(
        [sys.executable, "-m", "pixie_tpu_torch.deploy", "operator"],
        env=env, cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT,
    )
    seen = set()
    t0 = time.monotonic()
    phases: dict = {}  # phase -> seconds since the operator started

    def log_tail() -> str:
        log.flush()
        return (tmp_path / "operator.log").read_text()[-2000:]

    def answered() -> bool:
        assert op.poll() is None, f"operator exited {phases}\n{log_tail()}"
        assert time.monotonic() < deadline, (
            f"the cluster never answered {phases}\n{log_tail()}")
        try:
            with Client("127.0.0.1", port, connect_timeout_s=1.0) as c:
                out = c.execute_script(SEQ_QUERY, timeout_s=10)["output"]
            return int(np.sum(out["n"])) == 64
        except Exception:
            time.sleep(0.5)
            return False

    try:
        assert _wait(lambda: set(_children(op.pid).values()) == {
            "broker", "pem", "kelvin"}, timeout_s=30.0), log_tail()
        phases["children"] = time.monotonic() - t0
        seen |= set(_children(op.pid))
        while not answered():
            pass
        phases["answered"] = time.monotonic() - t0
        (pem,) = [p for p, r in _children(op.pid).items() if r == "pem"]
        os.kill(pem, signal.SIGKILL)
        t_kill = time.monotonic()
        assert _wait(lambda: "pem" in _children(op.pid).values()
                     and pem not in _children(op.pid), timeout_s=10.0), (
            f"no PEM restarted {phases}\n{log_tail()}")
        # Restarted within the first backoff (0.5 s) and a reconcile
        # interval (1 s), with room for a loaded host.
        phases["restart_s"] = time.monotonic() - t_kill
        assert phases["restart_s"] < 5.0, phases
        seen |= set(_children(op.pid))
        while not answered():
            pass
        phases["answered_again"] = time.monotonic() - t0
    finally:
        op.send_signal(signal.SIGTERM)
        try:
            op.wait(timeout=30)
        except subprocess.TimeoutExpired:
            op.kill()
            op.wait(timeout=10)
        log.seek(0)
        text = log.read()
        log.close()
    assert op.returncode == 0, text[-2000:]
    assert "[operator] reconciling roles: {'broker': 1, 'pem': 1, " \
           "'kelvin': 1}" in text
    assert len(seen) == 4, (seen, phases)  # three roles, the new PEM
    assert all(_gone(p) for p in seen), [p for p in seen if not _gone(p)]


# -- the soak (opt-in) --------------------------------------------------------


@pytest.mark.skipif(not os.environ.get("PIXIE_TPU_SOAK"),
                    reason="soak is opt-in: set PIXIE_TPU_SOAK=1")
def test_soak_query_through_role_kill():
    """tests/test_soak.py's scenario on the port's roles (CPU): a broker,
    a PEM and a Kelvin under the operator, queried continuously over the
    netbus, a PEM SIGKILLed at 20 s; every query from 30 s after the kill
    succeeds, and the operator recorded the crash and the restart."""
    from pixie_tpu_torch.api import Client

    port = _free_port()
    role_env = (
        ("PIXIE_TPU_NETBUS_PORT", str(port)),
        ("PIXIE_TPU_BROKER", f"127.0.0.1:{port}"),
        ("PIXIE_TPU_OBS_PORT", "0"), ("PIXIE_TPU_SEQGEN", "1"),
        ("PIXIE_TPU_TORCH_DEVICE", "cpu"), ("PYTHONPATH", str(REPO)),
    )
    specs = {r: RoleSpec(name=r, replicas=1, env=role_env)
             for r in ("broker", "pem", "kelvin")}
    rec = Reconciler(specs, base_backoff_s=0.2, max_backoff_s=1.0)
    rec.run_as_thread()
    results = []

    def one_query():
        try:
            with Client("127.0.0.1", port, connect_timeout_s=2.0) as c:
                out = c.execute_script(SEQ_QUERY, timeout_s=15)["output"]
            return int(np.sum(out["n"])) > 0
        except Exception:
            return False

    killed_t = None
    try:
        deadline = time.time() + 90
        while time.time() < deadline and not one_query():
            time.sleep(2)
        kill_at, end = time.time() + 20, time.time() + 90
        while time.time() < end:
            t0 = time.time()
            results.append((t0, one_query()))
            if killed_t is None and time.time() >= kill_at:
                (st,) = [s for s in rec.status()
                         if s["role"] == "pem" and s["alive"]]
                os.kill(st["pid"], signal.SIGKILL)
                killed_t = time.time()
            time.sleep(2)
    finally:
        rec.stop()
    assert killed_t is not None
    tail = [ok for t, ok in results if t > killed_t + 30]
    assert tail and all(tail)
    assert all(ok for t, ok in results if t <= killed_t)
    kinds = [e[1] for e in rec.events]
    assert "crashed" in kinds and "restarted" in kinds
