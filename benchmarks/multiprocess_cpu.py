"""True multi-process run of the distributed Monte-Carlo backend (CPU).

SURVEY.md section 5.8 requires the scenario-sharded path to work across
processes (hosts), with statistics reduced by collectives riding the
inter-process fabric (Gloo over localhost here, on virtual CPU devices).
This
script launches N real `jax.distributed` processes, each owning
`--devices-per-process` virtual CPU devices, builds the identical system
in every process (deterministic from the config seed), assembles the
global scenario batch from process-local shards
(parallel/multihost.global_scenarios), runs
`parallel.montecarlo.run_sharded` over the global 2-process mesh
(psum across processes!), and asserts the statistics match a
single-process run of the same scenarios.

Throughput mode (VERDICT r4 #7): the r4 artifact was correctness-only
(2-process Gloo at toy scale ran 8x SLOWER than single-process).  With
MP_THROUGHPUT=1 the driver additionally times a STRONG-SCALING row
family: a fixed global scenario batch (MP_TOTAL, default 256 at R=64,
large enough to amortize the Gloo rendezvous) run at 1/2/4 processes,
each worker timing its post-compile run_sharded between coordination
barriers.  CPU-indicative only: this host has 2 cores, so >=2-process
rows measure oversubscribed contention, not fabric scaling -- the
point is that throughput is MEASURED end-to-end through the real
multi-process collective path, with the caveat recorded in the
artifact.

Driver mode (default):  python benchmarks/multiprocess_cpu.py [out.json]
Worker mode (spawned):  ... --process-id I --num-processes N
Env: MP_RES=64 MP_STEPS=20 MP_SPD=4 MP_NPROC=2 MP_DPP=4 MP_PORT=9917
     MP_THROUGHPUT=1 MP_TOTAL=256 MP_NPROCS_LIST=1,2,4 MP_TIMED_REPS=3
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

RES = int(os.environ.get("MP_RES", "64"))
STEPS = int(os.environ.get("MP_STEPS", "20"))
SPD = int(os.environ.get("MP_SPD", "4"))          # scenarios per device
NPROC = int(os.environ.get("MP_NPROC", "2"))
DPP = int(os.environ.get("MP_DPP", "4"))          # devices per process
PORT = int(os.environ.get("MP_PORT", "9917"))
TIMED = bool(os.environ.get("MP_TIMED"))          # worker: emit TIME
TIMED_REPS = int(os.environ.get("MP_TIMED_REPS", "3"))


def _build_and_scenarios():
    import dataclasses

    import jax

    from mpc_sensorlessao_tpu.models import pipeline
    from mpc_sensorlessao_tpu.parallel import montecarlo
    from mpc_sensorlessao_tpu.utils.config import reference_config

    cfg = reference_config(resolution=RES)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=STEPS))
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    n = SPD * NPROC * DPP
    scen = montecarlo.make_scenarios(
        cfg, jax.random.PRNGKey(1), n,
        d_over_r0_grid=(5.0, 10.0), snr_db_grid=(5.0, 10.0))
    return cfg, system, scen, n


def worker(pid: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DPP}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=NPROC, process_id=pid)
    assert jax.process_count() == NPROC
    assert len(jax.devices()) == NPROC * DPP

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpc_sensorlessao_tpu.parallel import (mesh as mesh_lib,
                                               montecarlo, multihost)

    # Gloo contexts for the global clique are created lazily at the
    # first collective with a ~30 s rendezvous timeout; run a tiny
    # warmup all-reduce NOW, while the processes are still in lockstep
    # after initialize() -- the long, skewed build below would otherwise
    # leave one process waiting past the rendezvous deadline.
    wmesh = mesh_lib.scenario_mesh()
    local = np.ones((DPP,), dtype=np.float32)
    g = jax.make_array_from_process_local_data(
        NamedSharding(wmesh, P(mesh_lib.SCENARIO_AXIS)), local,
        (NPROC * DPP,))
    total = jax.jit(jnp.sum,
                    out_shardings=NamedSharding(wmesh, P()))(g)
    assert float(total) == float(NPROC * DPP)

    cfg, system, scen, n = _build_and_scenarios()

    # re-sync before the first real collective: the builds/compiles
    # above are long and skewed across processes; the coordination
    # service barrier (not Gloo) tolerates that skew
    from jax._src import distributed as _dist
    _dist.global_state.client.wait_at_barrier("post_build", 600_000)
    # every process holds the same global batch (deterministic build);
    # keep only this process's contiguous shard and assemble the global
    # sharded batch from the local pieces -- the real multi-host pattern
    # where each host only materializes its own scenarios
    per = n // NPROC
    local = jax.tree.map(lambda a: a[pid * per:(pid + 1) * per], scen)
    mesh = mesh_lib.scenario_mesh()
    scen_g = multihost.global_scenarios(local, mesh)
    runner = montecarlo.make_sharded_runner(
        system.loop, system.layers, cfg, STEPS, mesh)
    stats = runner(scen_g)
    if pid == 0:
        print("STATS " + json.dumps(
            {k: float(v) for k, v in stats._asdict().items()}), flush=True)
    if TIMED:
        # post-compile throughput: barrier-aligned best-of reps through
        # the already-jitted collective program
        from jax._src import distributed as _dist
        best = float("inf")
        for rep in range(TIMED_REPS):
            _dist.global_state.client.wait_at_barrier(
                f"time_{rep}", 600_000)
            t0 = time.time()
            stats = runner(scen_g)
            float(stats.mean_rms_res)       # host fetch = real sync
            best = min(best, time.time() - t0)
        if pid == 0:
            print("TIME " + json.dumps({"best_s": best, "n_scen": n,
                                        "steps": STEPS}), flush=True)


def driver(out_path: str) -> None:
    # single-process reference statistics on this process's own devices
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DPP}")
    import jax

    jax.config.update("jax_platforms", "cpu")

    from mpc_sensorlessao_tpu.parallel import mesh as mesh_lib
    from mpc_sensorlessao_tpu.parallel import montecarlo

    cfg, system, scen, n = _build_and_scenarios()
    mesh = mesh_lib.scenario_mesh()
    t0 = time.time()
    ref = montecarlo.run_sharded(system.loop, system.layers, cfg, scen,
                                 n_steps=STEPS, mesh=mesh)
    ref = {k: float(v) for k, v in ref._asdict().items()}
    t_single = time.time() - t0

    # spawn the real multi-process job.  Worker output goes to temp
    # FILES, not pipes: sequential communicate() over PIPE-captured
    # workers can deadlock when an undrained worker fills its 64KB pipe
    # buffer with jax/gloo logging and blocks mid-collective.
    import tempfile

    env = dict(os.environ)
    procs, logs = [], []
    t0 = time.time()
    for pid in range(NPROC):
        f = tempfile.TemporaryFile(mode="w+", prefix=f"mp_worker{pid}_")
        logs.append(f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--process-id", str(pid)],
            stdout=f, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))))
    for p in procs:
        p.wait(timeout=1200)
    t_multi = time.time() - t0
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    failed = [pid for pid, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for pid, o in enumerate(outs):
            print(f"--- worker {pid} ---\n{o[-4000:]}", file=sys.stderr)
        raise SystemExit(f"workers {failed} failed")
    line = [ln for ln in outs[0].splitlines()
            if ln.startswith("STATS ")][-1]
    multi = json.loads(line[len("STATS "):])

    deltas = {k: abs(multi[k] - ref[k]) for k in ref}
    # identical scenarios, different reduction topology: f32 psum order
    # differences only
    for k in ("mean_rms_res", "mean_rms_turb", "mean_strehl",
              "mean_strehl_exact"):
        rel = deltas[k] / (abs(ref[k]) + 1e-12)
        assert rel < 1e-4, (k, ref[k], multi[k])
    assert multi["n_scenarios"] == ref["n_scenarios"]
    assert multi["n_diverged"] == ref["n_diverged"]

    report = {
        "what": ("REAL multi-process jax.distributed run of "
                 "parallel/multihost + montecarlo.run_sharded: "
                 f"{NPROC} processes x {DPP} CPU devices over localhost "
                 "Gloo, psum across process boundaries; statistics match "
                 "the single-process run of the same scenarios"),
        "resolution": RES, "n_steps": STEPS, "n_scenarios": n,
        "num_processes": NPROC, "devices_per_process": DPP,
        "single_process_s": round(t_single, 1),
        "multi_process_wall_s": round(t_multi, 1),
        "stats_single": ref, "stats_multi": multi,
        "max_rel_delta": max(
            deltas[k] / (abs(ref[k]) + 1e-12) for k in ref),
        "ok": True,
    }

    if os.environ.get("MP_THROUGHPUT"):
        report["throughput"] = throughput_rows()

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(json.dumps(report, indent=2))


def throughput_rows() -> dict:
    """Strong-scaling steps/s at 1/2/4 processes (see module docstring).

    Each row spawns nproc timed workers over a FIXED global batch of
    MP_TOTAL scenarios with 1 device per process; workers time their
    post-compile run_sharded between coordination barriers and worker 0
    reports the best rep.  This 2-core host makes >=2-process rows an
    oversubscription measurement -- recorded as such."""
    import tempfile

    total = int(os.environ.get("MP_TOTAL", "256"))
    nprocs = [int(x) for x in
              os.environ.get("MP_NPROCS_LIST", "1,2,4").split(",")]
    rows = {"global_scenarios": total, "n_steps": STEPS,
            "resolution": RES, "host_cores": os.cpu_count(),
            "caveat": ("single host, oversubscribed beyond "
                       f"{os.cpu_count()} cores: rows measure the real "
                       "multi-process collective path, not fabric "
                       "scaling"),
            "rows": {}}
    for np_i, nproc in enumerate(nprocs):
        env = dict(os.environ)
        env.update({
            "MP_TIMED": "1", "MP_NPROC": str(nproc), "MP_DPP": "1",
            "MP_SPD": str(total // nproc),
            "MP_PORT": str(PORT + 10 + np_i),
        })
        procs, logs = [], []
        t0 = time.time()
        for pid in range(nproc):
            f = tempfile.TemporaryFile(mode="w+",
                                       prefix=f"mp_tp{nproc}_{pid}_")
            logs.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--process-id", str(pid)],
                stdout=f, stderr=subprocess.STDOUT, text=True, env=env,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))))
        for p in procs:
            p.wait(timeout=2400)
        wall = time.time() - t0
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        failed = [pid for pid, p in enumerate(procs)
                  if p.returncode != 0]
        if failed:
            for pid, o in enumerate(outs):
                print(f"--- tp worker {pid} ---\n{o[-3000:]}",
                      file=sys.stderr)
            raise SystemExit(f"throughput workers {failed} failed "
                             f"(nproc={nproc})")
        line = [ln for ln in outs[0].splitlines()
                if ln.startswith("TIME ")][-1]
        t = json.loads(line[len("TIME "):])
        rows["rows"][f"nproc={nproc}"] = {
            "best_run_s": round(t["best_s"], 3),
            "steps_per_s": round(total * STEPS / t["best_s"], 1),
            "wall_s_incl_build": round(wall, 1),
        }
        print(f"nproc={nproc}", rows["rows"][f"nproc={nproc}"],
              file=sys.stderr, flush=True)
    base = rows["rows"].get("nproc=1")
    if base:
        for k, v in rows["rows"].items():
            v["speedup_vs_1proc"] = round(
                v["steps_per_s"] / base["steps_per_s"], 2)
    return rows


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if "--process-id" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--process-id") + 1]))
    else:
        out = (sys.argv[1] if len(sys.argv) > 1 and
               not sys.argv[1].startswith("-") else "MULTIPROC.json")
        driver(out)


if __name__ == "__main__":
    main()
