"""``python -m freedm_tpu_torch serve`` — run the power-flow server.

    python -m freedm_tpu_torch serve --port 8080 --pf-backend auto --pf-precision auto

serves ``POST /v1/pf``, ``/v1/n1`` and ``/v1/vvc`` (plus ``/healthz``,
``/stats``, ``/metrics``) on the card until interrupted, with the incremental cache tier on
(``--cache-mb 0`` turns it off), and the QSTS jobs API (``POST /v1/qsts``,
``GET /v1/jobs/<id>``, ``POST /v1/jobs/<id>/cancel``) on a
:class:`~freedm_tpu_torch.scenarios.jobs.JobManager` of ``--qsts-workers``
workers; keyed jobs checkpoint into ``--qsts-checkpoint-dir`` and resume
from it.  ``--device cpu`` runs the plain PyTorch path on the CPU
instead.
"""

from __future__ import annotations

import argparse
import signal
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m freedm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve",
                        help="run the POST /v1/{pf,n1,vvc,qsts} server")
    sp.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral, printed at start)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--pf-backend", default="auto",
                    choices=("dense", "sparse", "auto"))
    sp.add_argument("--pf-precision", default="auto",
                    choices=("f64", "mixed", "auto"),
                    help="inner-solve precision of the sparse backend "
                         "(auto: mixed on the card, f64 on the CPU)")
    sp.add_argument("--max-batch", type=int, default=64)
    sp.add_argument("--max-wait-ms", type=float, default=2.0)
    sp.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    sp.add_argument("--prewarm", action="append", default=[],
                    help="workload/case to run through every bucket at start "
                         "(e.g. pf/mesh2000, vvc/vvc_9bus)")
    sp.add_argument("--cache-mb", type=float, default=64.0,
                    help="byte budget of the incremental serving cache, "
                         "solutions plus artifacts (0 disables it)")
    sp.add_argument("--cache-ttl-s", type=float, default=600.0,
                    help="age after which a cached solution is not served")
    sp.add_argument("--delta-max-rank", type=int, default=16,
                    help="most changed buses the delta tier corrects "
                         "before falling to a warm-seeded full solve")
    sp.add_argument("--qsts-workers", type=int, default=1,
                    help="QSTS job workers (the studies share one card)")
    sp.add_argument("--qsts-max-jobs", type=int, default=16,
                    help="pending QSTS jobs before submissions are shed "
                         "with 'overloaded'")
    sp.add_argument("--qsts-chunk-steps", type=int, default=24,
                    help="default timesteps a QSTS chunk (and checkpoint)")
    sp.add_argument("--qsts-checkpoint-dir", default=None,
                    help="directory keyed QSTS jobs checkpoint into and "
                         "resume from (unset: no resume)")
    sp.add_argument("--qsts-agents-max", type=int, default=1_000_000,
                    help="largest agent population a QSTS job may attach")
    sp.add_argument("--qsts-agents-cells-max", type=int, default=4_000_000,
                    help="largest scenarios x agents a QSTS job may attach")
    args = ap.parse_args(argv)

    from freedm_tpu_torch.scenarios.jobs import JobManager
    from freedm_tpu_torch.serve.http import ServeServer
    from freedm_tpu_torch.serve.service import ServeConfig, Service

    svc = Service(ServeConfig(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        pf_backend=args.pf_backend, pf_precision=args.pf_precision,
        device=args.device,
        prewarm=tuple(args.prewarm),
        cache_mb=args.cache_mb, cache_ttl_s=args.cache_ttl_s,
        delta_max_rank=args.delta_max_rank,
    ))
    jobs = JobManager(
        workers=args.qsts_workers, max_pending=args.qsts_max_jobs,
        checkpoint_dir=args.qsts_checkpoint_dir,
        default_chunk_steps=args.qsts_chunk_steps,
        agents_max=args.qsts_agents_max,
        agents_cells_max=args.qsts_agents_cells_max, device=args.device,
    ).start()
    server = ServeServer(svc, port=args.port, host=args.host,
                         jobs=jobs).start()
    print(f"serving on http://{args.host}:{server.port} "
          f"(device {svc.device})", flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        while not done.wait(0.5):  # wake so the signal handler can run
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        jobs.stop()
        svc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
