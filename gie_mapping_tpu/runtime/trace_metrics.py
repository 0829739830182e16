"""Device time per engine stage from a `jax.profiler` trace.

Stages are the named scopes the engine puts on its hot ops (STAGES).  A
kernel's stage comes from the `op_name` metadata of its HLO instruction in
XLA's optimized-HLO text dump (`--xla_dump_to=DIR --xla_dump_hlo_as_text`):
a fusion belongs to a stage when its own op_name or that of any op fused
into it carries the scope.

    m = stage_metrics(xplane_path, hlo_stage_map(dump_dir))
    m["busy_ns"], m["idle_share"], m["stage_ns"]["edt_envelope"]

Device events are the GPU planes' kernel events; on a CPU-only run (tests)
the host plane's XLA op events stand in for them.
"""
from __future__ import annotations

import glob
import os
import re

STAGES = ("edt_envelope", "edt_phase1", "scroll", "panorama_lookup",
          "image_lookup", "stream_extract")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
# a computation header: `[ENTRY] %name (params...) -> type {`; parameter
# tuples may hold `/*index=5*/` comments, so '=' alone does not tell it
# from an instruction (`%name = type op(...)`)
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\{\s*$")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_MODULE = re.compile(r"^HloModule\s+([\w.\-]+)")


def _stage_of(names) -> str | None:
    for st in STAGES:
        if any(st in n for n in names):
            return st
    return None


def parse_hlo_text(text: str) -> tuple:
    """(module name, {instruction: stage or None}) of one optimized-HLO
    module text."""
    module = None
    comp_ops: dict = {}     # computation -> op_names inside it
    instrs = []             # (name, own op_name, called computations)
    comp = None
    for line in text.splitlines():
        m = _MODULE.match(line)
        if m:
            module = m.group(1)
            continue
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if m and comp is not None:
            name, rest = m.groups()
            op = _OPNAME.search(rest)
            own = op.group(1) if op else ""
            comp_ops.setdefault(comp, []).append(own)
            instrs.append((name, own, _CALLS.findall(rest)))
            continue
        if line.strip() == "}":
            comp = None
    out = {}
    for name, own, calls in instrs:
        names = [own] + [n for c in calls for n in comp_ops.get(c, [])]
        out[name] = _stage_of(names)
    return module, out


def _norm(name: str) -> str:
    """Kernel and HLO instruction names agree up to '.'/'-' vs '_'."""
    return name.replace(".", "_").replace("-", "_")


def hlo_stage_map(dump_dir: str) -> list:
    """[(program id, module name, {instruction: stage or None})] of every
    optimized-HLO text file in an XLA dump directory
    (`module_<id>.<name>...`; the id is the `program_id` of the program's
    trace events).  Instruction names are normalized with `_norm`."""
    out = []
    for path in glob.glob(os.path.join(dump_dir,
                                       "module_*after_optimizations.txt")):
        pid = int(re.match(r"module_(\d+)", os.path.basename(path)).group(1))
        with open(path) as f:
            module, instrs = parse_hlo_text(f.read())
        out.append((pid, module, {_norm(k): v for k, v in instrs.items()}))
    return out


def _stats(ev) -> dict:
    return {k: v for k, v in ev.stats}


def device_events(xplane_path: str) -> list:
    """[(start_ns, end_ns, kernel name, program id, module, hlo_op)] of the
    device kernels in a trace: the GPU planes' stream lines, or, when there
    is no GPU plane, the host plane's XLA op events."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    host = not planes
    if host:
        planes = [p for p in data.planes if p.name == "/host:CPU"]
    out = []
    for p in planes:
        lines = list(p.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                st = _stats(ev)
                if (host or not streams) and "hlo_op" not in st:
                    continue
                out.append((int(ev.start_ns), int(ev.end_ns), ev.name,
                            int(st.get("program_id", -1)),
                            str(st.get("hlo_module", "")),
                            str(st.get("hlo_op", ev.name))))
    return out


def _union_ns(intervals) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _resolver(modules, evs):
    """fn(event) -> stage: the event's program (by program id, else module
    name, else the module that names the most events) and instruction (its
    hlo_op stat, else its kernel name)."""
    by_pid = {pid: ins for pid, _, ins in modules}
    by_name = {}
    for _, name, ins in modules:
        by_name.setdefault(name, {}).update(ins)
    names = {_norm(e[2]) for e in evs} | {_norm(e[5]) for e in evs}
    best = max((ins for _, _, ins in modules),
               key=lambda ins: len(names & ins.keys()), default={})

    def stage(ev):
        _, _, name, pid, module, op = ev
        ins = by_pid.get(pid) or by_name.get(module) or best
        return (ins.get(_norm(op)) or ins.get(_norm(name))
                or best.get(_norm(name)) or "other")
    return stage


def stage_metrics(xplane_path: str, modules, window_ns=None) -> dict:
    """Busy time, idle share and per-stage kernel time of a trace.

    modules: hlo_stage_map(dump_dir).  window_ns: the span the idle share
    is taken over (default: first kernel start to last kernel end).
    Kernels with no stage count under "other"."""
    evs = device_events(xplane_path)
    if not evs:
        raise ValueError(f"no device events in {xplane_path}")
    busy = _union_ns((s, e) for s, e, *_ in evs)
    span = window_ns or (max(e for _, e, *_ in evs)
                         - min(s for s, *_ in evs))
    stage_of = _resolver(modules, evs)
    stage_ns = {st: 0 for st in STAGES}
    stage_ns["other"] = 0
    top: dict = {}
    for ev in evs:
        s, e, name = ev[0], ev[1], ev[2]
        stage_ns[stage_of(ev)] += e - s
        top[name] = top.get(name, 0) + e - s
    return {"busy_ns": busy, "window_ns": span,
            "idle_share": 1.0 - busy / span if span else 0.0,
            "kernel_ns": sum(e - s for s, e, *_ in evs),
            "stage_ns": stage_ns, "n_events": len(evs),
            "top_kernels": sorted(top.items(), key=lambda kv: -kv[1])[:15]}
