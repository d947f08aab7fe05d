"""The V-cycle kernels K3 mg_down and K4 mg_up against their byte bound,
in %: the bytes of the V-cycles the traced frames' solves applied (one per
CG iteration and one before the first, for each solve that ran, counted
from StepDiagnostics), each level's input read once and output written
once (peaks.vcycle_bytes), over the HBM rate, divided by the device time
of the mg_down / mg_up kernels in the trace."""


def read(run):
    if not run.trace["k34_s"]:
        return None
    per_cycle = run.vcycle_bytes
    total = 0
    for d in run.diags:
        total += (d.pressure_iterations + d.substeps) * per_cycle["pressure"]
        if d.viscosity_tolerance > 0:
            total += ((d.viscosity_iterations + d.substeps)
                      * per_cycle["viscosity"])
    return 100.0 * total / run.hbm_bytes_per_s / run.trace["k34_s"]
