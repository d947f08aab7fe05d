"""Stream time of the viscosity solve's preconditioner over the traced
frames' substeps, in ms: the program's own viscosity_precond spans, one
around each apply of the preconditioner (iterations + 1 a solve, inside
pcg.apply_M, which also holds the pressure solve's V-cycles;
StepDiagnostics.stages: the time the stream took from each span's start
marker to its end marker). None where the frames hold no stages (a program
without them) or no such span (a program that does not span the
preconditioner, or ran no viscosity solve)."""

SPAN = "viscosity_precond"


def read(run):
    stages = [getattr(d, "stages", None) for d in run.diags]
    if not run.substeps or not all(stages):
        return None
    ran = [s[SPAN]["stream_ms"] for s in stages if SPAN in s]
    return sum(ran) / run.substeps if ran else None
