"""Prompt tokens of every call whose first tokens reached the host in the
window, over the window's seconds (host clock)."""


def read(run):
    w = run.window
    return w.prompt_tokens / w.seconds if w.calls and w.seconds > 0 else None
