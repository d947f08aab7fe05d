"""Stream time of the coupled viscosity operator over the traced frames'
substeps, in ms: the program's own viscosity_operator spans, one around
each apply of the operator (each CG iteration of the viscosity solve, its
warm start's residual and the system build's RHS coupling;
StepDiagnostics.stages: the time the stream took from each span's start
marker to its end marker). None where the frames hold no stages (a program
without them) or no such span (a program that does not span the
operator)."""

SPAN = "viscosity_operator"


def read(run):
    stages = [getattr(d, "stages", None) for d in run.diags]
    if not run.substeps or not all(stages):
        return None
    ran = [s[SPAN]["stream_ms"] for s in stages if SPAN in s]
    return sum(ran) / run.substeps if ran else None
