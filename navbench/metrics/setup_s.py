"""setup_s: seconds from the start of the process to the first timed step
(import, CUDA context, kernel library, statics, policy, reset, warm-up),
less the harness's own draw of the episode layouts, which no change to
the program can move (printed apart on standard error)."""


def read(ctx, suffix):
    return ctx["setup_s"]
