"""graph_captures: CUDA graphs the program captured inside the window
(graphs.counts); set-up that leaks into the window shows here."""


def read(run):
    return run.graph_captures
