"""Synchronising calls a step on the host: the warnings of
torch.cuda.set_sync_debug_mode("warn") over one call of the window's
entry, over its steps.  A read that the program makes with the mode
switched off (the Context's one latch read a chunk) is not seen."""


def read(trace):
    return trace.syncs / trace.sync_steps
