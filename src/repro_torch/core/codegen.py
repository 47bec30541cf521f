"""Multi-device code generation (paper §3.3).

Consumes the transformed graph, the execution schedule, the planned tensor
addresses and the per-node tiling solution, and emits:

* ``host_main.c``      — graph runtime for the host: initializes the memory
  pool, drives kernel invocations and DMA ops in the optimizer's temporal
  order, dispatches task descriptors to the accelerator mailboxes and waits
  on completion flags (polling or event-based per the platform spec);
* ``device_<d>.c``     — one dispatch-loop runtime per accelerator (distinct
  ISA toolchains on the real SoC; §3.3);
* ``kernels_<d>.c``    — per-supernode kernel entry points with the selected
  L1 tiling (loop order + factors from the ZigZag mapper) baked in;
* ``schedule.json``    — the executable schedule (start/end per node,
  resources, tile segments) for inspection and for the simulator;
* ``memory_map.json``  — L2 address assignments and swap points;
* ``Makefile``         — one target per ISA, linked into a single image.

The paper uses Mako templates; this environment has none installed, so plain
Python f-string templates are used — the artifact structure is the same.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from repro_torch.core.schedule import ExecutionPlan
from repro_torch.core.zigzag import map_supernode
from repro_torch.soc.device import SoC

_HOST_TMPL = """\
/* Generated by MATCHA-JAX — host graph runtime (mode={mode}).
 * Entry point: matcha_run(input, output).  Drives the schedule below. */
#include <stdint.h>
#include "matcha_platform.h"   /* user-provided platform C APIs (§3.3) */

#define L2_POOL_BYTES {l2_bytes}
static uint8_t *l2_pool;        /* planned memory pool (memory_map.json) */

{descriptors}

int matcha_run(const void *input, void *output) {{
  l2_pool = plat_l2_pool();
  plat_devices_init();          /* load + start device runtimes */
{body}
  return 0;
}}
"""

_DEVICE_TMPL = """\
/* Generated by MATCHA-JAX — dispatch-loop runtime for device `{dev}`
 * (separate ISA/toolchain; compiled standalone and packaged into the
 * multi-architecture image). */
#include <stdint.h>
#include "matcha_platform.h"

void {dev}_main(void) {{
  for (;;) {{
    matcha_task_t t;
    plat_mailbox_wait(&t);           /* task descriptor from host (§3.3) */
    {dev}_kernels[t.kernel_id](t.args);
    plat_mailbox_signal_done(t.id);  /* completion -> host */
  }}
}}
"""


def _emit_descriptors(plan: ExecutionPlan) -> str:
    lines: List[str] = []
    for i, name in enumerate(plan.order):
        n = plan.nodes[name]
        if n.kind != "kernel":
            continue
        sn = plan.tiled.supernode(n.supernode)
        lines.append(
            f"/* {i:4d} */ "
            f"static const matcha_task_t t_{i} = "
            f"{{ .id={i}, .dev=DEV_{sn.device.upper()}, "
            f".kernel_id=K_{sn.name.upper()}, "
            f".tile_lo={sn.tile_lo}, .tile_hi={sn.tile_hi} }};")
    return "\n".join(lines)


def _emit_body(plan: ExecutionPlan, soc: SoC) -> str:
    host = soc.host.name
    lines: List[str] = []
    i = 0
    for name in plan.order:
        n = plan.nodes[name]
        if n.kind in ("load", "store"):
            d = "DMA_IN" if n.kind == "load" else "DMA_OUT"
            t = n.writes[0] if n.writes else n.reads[0]
            lines.append(f"  plat_dma_l3({d}, T_{_cid(t)});"
                         f"  /* t={n.start:.0f}..{n.end:.0f} */")
        elif n.kind in ("slice", "concat"):
            lines.append(f"  host_{n.kind}(/*{name}*/);"
                         f"  /* t={n.start:.0f}..{n.end:.0f} */")
        elif n.kind == "kernel":
            sn = plan.tiled.supernode(n.supernode)
            if sn.device == host:
                lines.append(f"  host_kernel_{_cid(sn.name)}();"
                             f"  /* t={n.start:.0f}..{n.end:.0f} */")
            else:
                lines.append(f"  plat_mailbox_post(DEV_{sn.device.upper()},"
                             f" &t_{i});  /* async, t={n.start:.0f}.. */")
            i += 1
    lines.append("  plat_wait_all();   /* drain outstanding completions */")
    return "\n".join(lines)


def _cid(s: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in s)


def _emit_kernels(plan: ExecutionPlan, soc: SoC, dev: str) -> str:
    g = plan.tiled.graph
    parts = [f"/* Kernels for device `{dev}` with ZigZag L1 tiling baked in */",
             '#include "matcha_platform.h"', ""]
    for sn in plan.tiled.supernodes:
        if sn.device != dev:
            continue
        m = map_supernode(g, sn, soc)
        ops = "+".join(g.ops[o].op_type for o in sn.op_names)
        parts.append(
            f"void k_{_cid(sn.name)}(void *args) {{\n"
            f"  /* fused: {ops}; tiles [{sn.tile_lo},{sn.tile_hi})/{sn.T};\n"
            f"   * L1 mapping: order={m.order} f_spatial={m.f_spatial} "
            f"f_channel={m.f_channel} footprint={m.l1_footprint}B */\n"
            f"  MATCHA_KERNEL_BODY({_cid(sn.name)});\n"
            f"}}")
    return "\n".join(parts)


def generate(plan: ExecutionPlan, soc: SoC, out_dir: str) -> Dict[str, str]:
    """Emit the deployment artifact; returns {relative path: contents}."""
    files: Dict[str, str] = {}
    files["host_main.c"] = _HOST_TMPL.format(
        mode=plan.mode, l2_bytes=soc.l2.size,
        descriptors=_emit_descriptors(plan),
        body=_emit_body(plan, soc))
    for d in soc.accelerators:
        files[f"device_{d.name}.c"] = _DEVICE_TMPL.format(dev=d.name)
        files[f"kernels_{d.name}.c"] = _emit_kernels(plan, soc, d.name)
    files[f"kernels_{soc.host.name}.c"] = _emit_kernels(plan, soc,
                                                        soc.host.name)

    files["schedule.json"] = json.dumps({
        "mode": plan.mode,
        "makespan_cycles": plan.makespan,
        "nodes": [{
            "name": n.name, "kind": n.kind, "resource": n.resource,
            "start": n.start, "end": n.end, "reads": n.reads,
            "writes": n.writes,
        } for n in (plan.nodes[x] for x in plan.order)],
    }, indent=1)
    files["memory_map.json"] = json.dumps({
        "l2_capacity": plan.memory.capacity,
        "peak": plan.memory.peak,
        "allocations": [{
            "tensor": a.tensor, "addr": a.addr, "size": a.size,
            "t_alloc": a.t_alloc,
            "t_free": None if a.t_free == float("inf") else a.t_free,
            "strategy": a.strategy,
        } for a in plan.memory.allocations],
        "swaps": [{"tensor": s.tensor, "dir": s.direction,
                   "bytes": s.bytes, "t": s.time}
                  for s in plan.memory.swaps],
    }, indent=1)

    targets = " ".join(f"image_{d}" for d in soc.devices)
    mk = [f"all: {targets} pack", ""]
    for d, dev in soc.devices.items():
        cc = "riscv64-unknown-elf-gcc" if dev.is_host else \
            f"riscv32-unknown-elf-gcc  # {d} toolchain"
        srcs = f"host_main.c kernels_{d}.c" if dev.is_host \
            else f"device_{d}.c kernels_{d}.c"
        mk += [f"image_{d}: {srcs}", f"\t{cc} -O3 -o $@ $^", ""]
    mk += ["pack:", "\tmatcha-pack " + " ".join(f"image_{d}"
                                                for d in soc.devices)
           + " -o matcha_image.bin", ""]
    files["Makefile"] = "\n".join(mk)

    os.makedirs(out_dir, exist_ok=True)
    for rel, content in files.items():
        with open(os.path.join(out_dir, rel), "w") as f:
            f.write(content)
    return files
