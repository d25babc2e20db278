"""Seconds from the process's start to the window's: interpreter and CUDA
start, the kernel libraries (built on a checkout's first run, loaded after),
the log marched on the card, the throwaway engine and its solve programs."""


def read(ctx):
    return ctx["setup_s"]
