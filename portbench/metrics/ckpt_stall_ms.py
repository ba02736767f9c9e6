"""All the time the training thread spent inside checkpoint calls in the
window (wait on the previous pending take, delete, take or async_take),
over the number of checkpoints, in ms."""


def read(run: dict):
    stalls = run["stalls_s"]
    return 1e3 * sum(stalls) / len(stalls) if stalls else None
