"""The share of the traced frames' viscosity solves that stopped at the
iteration cap without reaching their tolerance, in %: 100 x the sum of
StepDiagnostics.viscosity_unconverged (solves whose convergence read was
false) over the sum of viscosity_solves. None for a program without the
counters, or where no viscosity solve ran."""


def read(run):
    solves = [getattr(d, "viscosity_solves", None) for d in run.diags]
    if not solves or None in solves or not sum(solves):
        return None
    return 100.0 * sum(d.viscosity_unconverged for d in run.diags) \
        / sum(solves)
