"""Viscosity CG iterations per viscosity solve over the traced frames: the
sum of StepDiagnostics.viscosity_iterations over the sum of
viscosity_solves (the substeps whose viscosity CG ran). None for a program
without the solve counter, or where no viscosity solve ran."""


def read(run):
    solves = [getattr(d, "viscosity_solves", None) for d in run.diags]
    if not solves or None in solves or not sum(solves):
        return None
    return sum(d.viscosity_iterations for d in run.diags) / sum(solves)
