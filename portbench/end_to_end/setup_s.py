"""The set-up's seconds: from the process's start to the window's first
step (imports, the kernel libraries, the state, the warm-up)."""


def read(window):
    return window["setup_s"]
