"""Two engines, one front door: the ACAM tier as an LM semantic cache.

Routes a Zipf-repeat prompt trace through
`repro_torch.serve.semantic_cache.SemanticCacheService`:

    prompt -> hashing featurizer -> ONE matching kernel call per tick
        confident hit  -> response store (Eq. 14 nJ-scale energy)
        miss           -> `Engine` continuous-batching decode, admitted
                          back as a template (cache churn)

then snapshots the service, restores it WITHOUT the engine, and serves the
same hits bit-identically from the restored response store alone. The
checks at the end are the contract: one matching call per tick, the cache
counters conserve (hits + misses == error-free responses), every hit
replays the exact tokens decode produced when its template was admitted,
the hit path costs orders of magnitude less energy than a decode miss, and
the per-response energies sum exactly to the ledger. Twin of the JAX
package's `examples/lm_semantic_cache.py`; runs on the card unless
``--device cpu`` asks for the CPU.

    python -m repro_torch.examples.lm_semantic_cache
    python -m repro_torch.examples.lm_semantic_cache --requests 48 \\
        --unique 6 --temperature 0.7
"""
from __future__ import annotations

import argparse
import tempfile
import time


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"semantic-cache contract broken: {what}")


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--unique", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=device,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.device import resolve
    from repro_torch.models import lm
    from repro_torch.serve import spec as spec_lib
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.semantic_cache import (PromptRequest,
                                                  SemanticCacheService,
                                                  synthetic_prompt_trace)

    dev = resolve(args.device)
    cfg = configs.get(args.arch, smoke=True)
    params = lm.init_params(args.seed, cfg, device=dev)
    eng = Engine(cfg, params, batch_size=4, max_len=64,
                 temperature=args.temperature, seed=args.seed)

    spec = spec_lib.ServiceSpec(
        registry=spec_lib.RegistrySpec(num_features=64),
        scheduler=spec_lib.SchedulerSpec(slots=args.slots),
        cascade=spec_lib.CascadeSpec(backend="lm", tau=8.0,
                                     tau_units="count"),
        router=spec_lib.RouterSpec(max_templates=args.unique),
        mesh=spec_lib.MeshSpec(install=False))
    svc = SemanticCacheService.from_spec(spec, engine=eng, device=dev)
    svc.add_tenant("edge-0")

    trace = synthetic_prompt_trace(args.seed, vocab=cfg.vocab,
                                   n_unique=args.unique,
                                   n_requests=args.requests)
    t0 = time.time()
    out = svc.serve_prompts(PromptRequest("edge-0", p,
                                          max_new_tokens=args.max_new)
                            for p in trace)
    dt = time.time() - t0

    m = svc.metrics()
    ev = svc.obs.cache_events
    hits = [r for r in out if r.cache_hit]
    misses = [r for r in out if not r.cache_hit and r.error is None]
    print(f"{cfg.name} behind the ACAM semantic cache ({dev}):")
    print(f"  {len(out)} requests ({args.unique} unique prompts), "
          f"{len(hits)} hits / {len(misses)} decode misses in {dt:.2f}s")
    print(f"  match stage: {m['classify_dispatches']} matching calls "
          f"over {m['ticks']} ticks (one per tick)")
    hit_j = max((r.energy_j for r in hits), default=0.0)
    miss_j = min((r.energy_j for r in misses), default=0.0)
    print(f"  energy: hit path {hit_j * 1e9:.3f} nJ vs decode miss "
          f"{miss_j * 1e9:.1f} nJ; mean {m['nj_per_request']:.1f} "
          "nJ/request")

    _check(m["classify_dispatches"] == m["ticks"],
           "the match stage must stay ONE call per tick")
    served = sum(r.error is None for r in out)
    _check(ev.value(event="hit") + ev.value(event="miss") == served,
           "hits + misses must equal the served responses")
    decoded = {r.template_id: r.tokens for r in misses}
    _check(all(r.tokens == decoded[r.template_id] for r in hits),
           "a hit must replay the exact tokens decode produced")
    _check(len(hits) > 0 and miss_j > 100 * hit_j,
           "the hit path's energy must be orders below decode")
    total = 0.0
    for r in out:  # left to right: sum() of floats compensates rounding
        total += r.energy_j
    _check(abs(total - svc.obs.ledger.fleet_j()) < 1e-15,
           "per-response energies must sum to the fleet ledger")

    with tempfile.TemporaryDirectory() as d:
        svc.snapshot(Checkpointer(d))
        svc2, report = SemanticCacheService.restore(Checkpointer(d),
                                                    device=dev)
        replay = svc2.serve_prompts(
            PromptRequest("edge-0", p, max_new_tokens=args.max_new)
            for p in trace[:args.unique])
    _check(all(r.cache_hit for r in replay),
           "the restored response store must serve hits with NO engine")
    _check(all(r.tokens == decoded[r.template_id] for r in replay),
           "restored hits must replay the admitted tokens")
    print(f"  restore: step {report.step} adopted {report.tenants} "
          f"tenant(s); {len(replay)} hits served engine-less, "
          "bit-identical")
    print("OK")
    return {"hits": len(hits), "misses": len(misses), **m,
            "replayed": len(replay)}


if __name__ == "__main__":
    main()
