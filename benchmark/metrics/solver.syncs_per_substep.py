"""Host waits for the device made inside the traced frames, over the
traced substeps: cudaStreamSynchronize, cudaDeviceSynchronize and
cudaEventSynchronize calls and blocking cudaMemcpy calls. A device-to-host
read such as .item() is a cudaMemcpyAsync followed by one
cudaStreamSynchronize, so it counts once. Most are the PCG loop's
convergence test, one a CG iteration (solvers/pcg.py)."""


def read(run):
    if not run.substeps:
        return None
    return run.trace["syncs"] / run.substeps
