"""``python -m freedm_tpu_torch serve`` — run the power-flow server.

    python -m freedm_tpu_torch serve --port 8080 --pf-backend auto --pf-precision auto

serves ``POST /v1/pf`` (plus ``/healthz``, ``/stats``, ``/metrics``) on
the card until interrupted, with the incremental cache tier on
(``--cache-mb 0`` turns it off); ``--device cpu`` runs the plain PyTorch
path on the CPU instead.
"""

from __future__ import annotations

import argparse
import signal
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m freedm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("serve", help="run the POST /v1/pf server")
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
                    help="workload/case to run through every bucket at start")
    sp.add_argument("--cache-mb", type=float, default=64.0,
                    help="byte budget of the incremental serving cache, "
                         "solutions plus artifacts (0 disables it)")
    sp.add_argument("--cache-ttl-s", type=float, default=600.0,
                    help="age after which a cached solution is not served")
    sp.add_argument("--delta-max-rank", type=int, default=16,
                    help="most changed buses the delta tier corrects "
                         "before falling to a warm-seeded full solve")
    args = ap.parse_args(argv)

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
    server = ServeServer(svc, port=args.port, host=args.host).start()
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
        svc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
