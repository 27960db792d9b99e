"""CUDA graphs warmed up or captured during the window (the port's
``StepGraphs.warmups + captures``): work that set-up did not finish."""


def read(layer, trace):
    return float(layer["graph_captures_window"])
