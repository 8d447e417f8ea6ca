"""Command line of the port: one one-GPU join of two generated relations.

The one-GPU subset of ``tpu_radix_join/main.py``, with its flag names and
defaults: the inner relation is unique with seed ``--seed``, the outer one
of ``--outer-kind`` with seed ``--seed + 1``; the join runs through
``HashJoin(JoinConfig(...)).join_arrays`` on the placed relations.
``--probe bucket`` or ``--two-level`` select the partitioned join;
``--key-range`` picks the sort probe's 32-bit discipline.

Usage:
    python -m tpu_radix_join_torch.main --tuples-per-node 20000000
    python -m tpu_radix_join_torch.main --key-range full --tuples-per-node 20000000
    python -m tpu_radix_join_torch.main --probe bucket --tuples-per-node 20000000
    python -m tpu_radix_join_torch.main --two-level --outer-kind zipf --max-retries 2
    python -m tpu_radix_join_torch.main --device cpu --tuples-per-node 65536
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_radix_join_torch",
        description="One-GPU radix hash join (PyTorch + CUDA)")
    p.add_argument("--tuples-per-node", type=int, default=1 << 20,
                   help="tuples per relation (reference: 20M, main.cpp:70)")
    p.add_argument("--network-fanout", type=int, default=5,
                   help="network radix bits (Configuration.h:30)")
    p.add_argument("--local-fanout", type=int, default=5)
    p.add_argument("--two-level", action="store_true",
                   help="enable second-level partitioning (Configuration.h:28)")
    p.add_argument("--probe", choices=["sort", "bucket"], default="sort")
    p.add_argument("--key-range", choices=["auto", "narrow", "full"],
                   default="auto",
                   help="32-bit sort-probe discipline: the packed 31-bit "
                        "probe (narrow), the full-range one (full), or per "
                        "join from the key bounds (auto)")
    p.add_argument("--assignment", choices=["round_robin", "load_aware"],
                   default="round_robin")
    p.add_argument("--window-sizing", choices=["measured", "static"],
                   default="measured")
    p.add_argument("--max-retries", type=int, default=0,
                   help="capacity-shortfall retries with doubled shapes")
    p.add_argument("--outer-kind", choices=["unique", "modulo", "zipf"],
                   default="unique")
    p.add_argument("--modulo", type=int, default=None,
                   help="modulo of the outer keys (default: size // 4)")
    p.add_argument("--zipf-theta", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=1234,
                   help="base seed (reference: srand(1234+nodeId), main.cpp:94)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation

    n = args.tuples_per_node
    inner = Relation(n, 1, "unique", seed=args.seed)
    outer_kw = {}
    if args.outer_kind == "modulo":
        outer_kw["modulo"] = args.modulo or max(1, n // 4)
    elif args.outer_kind == "zipf":
        outer_kw["zipf_theta"] = args.zipf_theta
        outer_kw["key_domain"] = n
    outer = Relation(n, 1, args.outer_kind, seed=args.seed + 1, **outer_kw)
    expected = inner.expected_matches(outer)

    cfg = JoinConfig(network_fanout_bits=args.network_fanout,
                     local_fanout_bits=args.local_fanout,
                     two_level=args.two_level, probe_algorithm=args.probe,
                     assignment_policy=args.assignment,
                     window_sizing=args.window_sizing,
                     key_range=args.key_range,
                     max_retries=args.max_retries)
    engine = HashJoin(cfg, device=args.device)
    r, s = engine.place(inner), engine.place(outer)
    key_bound = max(inner.key_bound(), outer.key_bound())
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    result = engine.join_arrays(r, s, key_bound=key_bound)
    if cuda:
        torch.cuda.synchronize(engine.device)
    join_s = time.perf_counter() - t0
    ok = result.ok and (expected is None or result.matches == expected)
    print(json.dumps({
        "matches": result.matches, "ok": result.ok, "expected": expected,
        "join_ms": join_s * 1e3, "tuples": 2 * n,
        "tuples_per_s": 2 * n / join_s,
        "failure_class": result.diagnostics["failure_class"],
        "retries": result.retries,
        "pipeline": "sort_probe" if cfg.sort_probe else "partitioned",
        "key_range": args.key_range,
        "device": (torch.cuda.get_device_name(engine.device) if cuda
                   else "cpu"),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
