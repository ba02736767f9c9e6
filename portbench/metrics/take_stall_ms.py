"""All the time the training thread spent inside checkpoint calls in the
untraced window (wait on the previous pending take, delete, take or
async_take), over the number of checkpoints, in ms: what a checkpoint
costs the job, the part of ``train_tokens_per_s`` that the calls take."""


def read(run: dict):
    stalls = run["stalls_s"]
    return 1e3 * sum(stalls) / len(stalls) if stalls else None
