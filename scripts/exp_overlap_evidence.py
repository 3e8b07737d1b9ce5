"""Schedule-level evidence for the halo overlap credit (round-4 verdict
item 3a: "the P=8 claim is a model assumption wearing a checkmark").

The projection's ``eff_overlap`` assumes the halo all_to_all runs
concurrently with the interior bucket sweeps. The STRUCTURAL
precondition for that — and the thing XLA's latency-hiding scheduler
needs — is that the interior compute has no dependency edge to the
collective, and the scheduler actually places independent compute
between the collective's operands and its first consumer. This script
compiles the distributed fused attention (forward AND gradient) on the
8-device CPU mesh, parses the scheduled optimized HLO of the entry
computation, and measures:

  * every all-to-all instruction (forward k/v exchange, reverse dk‖dv);
  * the dependency cone: which dot/fusion instructions are transitively
    DOWNSTREAM of each collective (boundary sections) vs independent
    (interior sections);
  * the schedule interleaving: how many independent compute
    instructions the scheduler placed BETWEEN the collective and its
    first consumer — the window an async start/done pair would stretch
    over. (XLA:CPU executes the printed sequence in order; on a GPU the
    same dependency structure is what the latency-hiding scheduler
    converts into start/done with compute in between.)

Assertions (also pinned by tests/test_overlap_hlo.py):
  fwd: ≥1 all-to-all; ≥1 interior score-dot NOT downstream of it;
       ≥1 independent compute instruction scheduled between the
       collective and its first consumer.
  bwd: the reverse exchange exists and the same two properties hold.

Run (CPU, host-only): python scripts/exp_overlap_evidence.py
(writes chiprun_out/overlap_evidence.json)
"""

import json
import os
import re
import sys

# This is a host-only compile analysis — always the CPU backend.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# Instruction: "%name = <type> op(operands...), attrs". Tuple-typed
# instructions (the all-to-all) have spaces/parens INSIDE the type, so
# the op is found as the first word followed by "(" that opens an
# operand list (next char is %, ), or a digit — e.g. parameter(0)).
_NAME = re.compile(r"^\s+(%[\w.\-]+)\s+=\s+(.*)$")
_OP = re.compile(r"([\w\-]+)\((?=%|\)|\d)")
_REF = re.compile(r"%[\w.\-]+")


def entry_schedule(hlo_text):
    """(name, op, operands, line) tuples for the ENTRY computation, in
    the printed (scheduled) order."""
    lines = hlo_text.splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("ENTRY"))
    out = []
    for l in lines[start + 1:]:
        if l.startswith("}"):
            break
        m = _NAME.match(l)
        if not m:
            continue
        name, rhs = m.groups()
        mo = _OP.search(rhs)
        if not mo:
            continue
        op = mo.group(1)
        # Operands only (stop at the attribute tail so calls=%... and
        # metadata don't become dependency edges).
        oplist = rhs[mo.end() - 1:].split("), ")[0]
        operands = [r for r in _REF.findall(oplist) if r != name]
        out.append((name, op, operands, l))
    return out


def analyze(sched, coll_op="all-to-all"):
    """Dependency + interleave analysis for each collective in sched."""
    by_name = {name: (i, op, operands)
               for i, (name, op, operands, _) in enumerate(sched)}
    # Transitive downstream set per collective (names).
    consumers = {name: [] for name in by_name}
    for name, op, operands, _ in sched:
        for o in operands:
            if o in consumers:
                consumers[o].append(name)

    def downstream(root):
        seen, stack = set(), [root]
        while stack:
            cur = stack.pop()
            for c in consumers.get(cur, ()):
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen

    compute_ops = {"dot", "fusion", "convolution"}
    results = []
    for name, op, operands, line in sched:
        if op != coll_op:
            continue
        idx = by_name[name][0]
        down = downstream(name)
        dots_total = [n for n, o, _, _ in sched if o == "dot"]
        dots_down = [n for n in dots_total if n in down]
        dots_indep = [n for n in dots_total if n not in down]
        # First consumer position in the schedule.
        cons_pos = [by_name[c][0] for c in consumers[name]
                    if c in by_name]
        first_cons = min(cons_pos) if cons_pos else len(sched)
        between = [
            (n, o) for n, o, _, _ in sched[idx + 1:first_cons]
            if o in compute_ops and n not in down
        ]
        results.append(dict(
            name=name, sched_pos=idx, first_consumer_pos=first_cons,
            dots_total=len(dots_total),
            dots_downstream=len(dots_down),
            dots_independent=len(dots_indep),
            indep_compute_between=len(between),
            indep_between_ops=sorted(
                {o for _, o in between}),
        ))
    return results


def build_case():
    from custom_op_benchmark_tpu.graph import random_graph
    from custom_op_benchmark_tpu.parallel import (
        halo_ell, halo_graph, make_mesh, shard_halo_nodes,
    )
    from custom_op_benchmark_tpu.parallel.halo import halo_attention_ell

    mesh = make_mesh((8,), ("edge",))
    g = random_graph(4096, 32000, seed=0, power_law=True)
    hg = halo_graph(g, mesh)
    he = halo_ell(hg, mesh)
    d = 32
    x = np.random.default_rng(0).normal(
        size=(hg.n_pad, d)).astype(np.float32)
    xs = shard_halo_nodes(hg, mesh, jnp.asarray(x))

    fwd = jax.jit(lambda q: halo_attention_ell(hg, he, mesh, q, q, q))
    bwd = jax.jit(jax.grad(
        lambda q: (halo_attention_ell(hg, he, mesh, q, q, q) ** 2).sum()))
    return fwd, bwd, xs


def main():
    fwd, bwd, xs = build_case()
    rec = {}
    for tag, fn in (("forward", fwd), ("backward", bwd)):
        txt = fn.lower(xs).compile().as_text()
        sched = entry_schedule(txt)
        res = analyze(sched)
        rec[tag] = dict(n_sched_instrs=len(sched), collectives=res)
        print(f"{tag}: {len(res)} all-to-all instruction(s), "
              f"{len(sched)} scheduled instrs")
        for r in res:
            print(f"  {r['name']}: pos {r['sched_pos']} -> first "
                  f"consumer {r['first_consumer_pos']}; dots "
                  f"{r['dots_independent']}/{r['dots_total']} "
                  f"independent; {r['indep_compute_between']} "
                  f"independent compute instrs scheduled in the "
                  f"overlap window")
        assert res, f"{tag}: no all-to-all found"
        assert any(r["dots_independent"] > 0 for r in res), (
            f"{tag}: no interior dot independent of the exchange")
        assert any(r["indep_compute_between"] > 0 for r in res), (
            f"{tag}: scheduler placed no independent compute in the "
            f"collective's window")
    rec["verdict"] = (
        "interior sections carry no dependency edge to the exchange and "
        "the scheduler interleaves them into the collective window; an "
        "async collective scheduler gets the same freedom (this is the "
        "structural precondition eff_overlap credits)")
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/overlap_evidence.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"overlap_evidence": "ok"}))


if __name__ == "__main__":
    main()
