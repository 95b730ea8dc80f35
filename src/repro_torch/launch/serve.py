"""Serving launcher: continuous batching under synthetic load, on the card.

The port of ``repro/launch/serve.py``, with its flags and the mixed-length
workloads of ``repro_torch.serving.loadgen``:

  * ``--mode lm``        -- LM ``ServeEngine`` on a reduced decoder arch;
  * ``--mode surrogate`` -- ``SurrogateServeEngine`` on a fresh N-member
                            fleet (per-query ensemble mean + variability-band
                            width).

``--rate QPS`` switches from closed loop (all requests at t=0) to Poisson
arrivals; ``--lockstep`` runs the chunked baseline; ``--device cpu`` runs
the plain PyTorch path on the CPU (the default is the card, and without one
the launcher raises); ``--trace-dir`` writes the run's telemetry.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --lockstep
  PYTHONPATH=src python -m repro_torch.launch.serve --mode surrogate --rate 8
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import ServeEngine, SurrogateServeEngine
from repro_torch.serving.loadgen import (latency_percentiles, lm_workload,
                                         surrogate_workload)


def _report(tag: str, done, pct: dict, extra: str) -> None:
    print(f"{tag}: {len(done)} completed  "
          f"p50={pct['p50'] * 1e3:.1f}ms p99={pct['p99'] * 1e3:.1f}ms  "
          f"{extra}")


def serve_lm(args) -> list:
    cfg = reduced_config(args.arch)
    if cfg.encoder_layers:
        raise SystemExit("use the decode dry-run for enc-dec serving (python -m "
                         f"repro_torch.launch.dryrun --arch {args.arch} --cell decode_32k)")
    dev = resolve_device(args.device)
    params = lm.init_lm(0, cfg, device=dev)
    engine = ServeEngine(params, cfg, batch_slots=args.slots, max_seq=args.max_seq,
                         device=dev)
    reqs = lm_workload(cfg.vocab_size, args.requests,
                       rate_qps=args.rate, seed=args.seed)
    done = engine.run_lockstep(reqs) if args.lockstep else engine.run(reqs)
    for i, r in enumerate(done[:4]):
        print(f"req {i}: prompt[{len(r.prompt)}]={r.prompt.tolist()[:6]}... "
              f"-> {r.output.tolist()}")
    _report("lm" + ("/lockstep" if args.lockstep else ""),
            done, latency_percentiles(done),
            f"{engine.tokens_per_second:.1f} decode tok/s "
            f"({engine.prefill_tokens_per_second:.0f} prefill tok/s, "
            f"util={engine.slot_utilization:.2f}; device {dev})")
    return done


def serve_surrogate(args) -> list:
    from repro_torch.core.ensemble import init_ensemble
    from repro_torch.models.surrogate import SurrogateConfig
    cfg = SurrogateConfig(height=32, width=16, base_channels=32)
    dev = resolve_device(args.device)
    members = init_ensemble(cfg, list(range(args.members)), dev)
    engine = SurrogateServeEngine(members, cfg, batch_slots=args.slots, device=dev)
    queries = surrogate_workload(cfg.cond_dim - 1, args.requests,
                                 rate_qps=args.rate, seed=args.seed)
    done = (engine.run_lockstep(queries) if args.lockstep
            else engine.run(queries))
    q = next(d for d in done if d.steps > 0)
    print(f"query: T={q.steps} mean{q.mean.shape} "
          f"band width mean={float(q.width.mean()):.4f}")
    _report("surrogate" + ("/lockstep" if args.lockstep else ""),
            done, latency_percentiles(done),
            f"{engine.queries_per_second:.1f} q/s "
            f"util={engine.slot_utilization:.2f} "
            f"({args.members}-member fleet, one folded forward/step; device {dev})")
    return done


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "surrogate"), default="lm")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--members", type=int, default=2,
                    help="surrogate fleet size")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop Poisson arrival rate (qps); "
                         "default: closed loop")
    ap.add_argument("--lockstep", action="store_true",
                    help="run the chunked max(...) baseline instead of "
                         "continuous batching")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--trace-dir", default=None,
                    help="enable telemetry: write <run>.trace.json "
                         "(Perfetto-loadable) + <run>.events.jsonl here")
    args = ap.parse_args(argv)
    if args.trace_dir:
        obs_trace.configure(args.trace_dir, run=f"serve_{args.mode}")
    done = (serve_lm if args.mode == "lm" else serve_surrogate)(args)
    if args.trace_dir:
        paths = obs_trace.shutdown()
        print(f"trace: {paths['trace']}\nevents: {paths['events']}")
    return done


if __name__ == "__main__":
    main()
