"""Stream time of the grid update outside its two solves over the traced
frames' substeps, in ms: the program's grid_update span less its
viscosity_* and pressure_* spans, so the transfer's normalisation, the two
extrapolations, the body force, the viscosity test and the constraint
(StepDiagnostics.stages: the time the stream took from each span's start
marker to its end marker). None where the frames hold no stages (a
program without them)."""

SOLVES = ("viscosity_build", "viscosity_solve", "viscosity_apply",
          "pressure_build", "pressure_solve", "pressure_apply")


def read(run):
    stages = [getattr(d, "stages", None) for d in run.diags]
    if not run.substeps or not all(s and "grid_update" in s for s in stages):
        return None
    return sum(s["grid_update"]["stream_ms"]
               - sum(s[n]["stream_ms"] for n in SOLVES if n in s)
               for s in stages) / run.substeps
