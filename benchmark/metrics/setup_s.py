"""Seconds from the start of the run's process until the window opens:
loading the program, building or loading its kernels, making the inputs,
warming up."""


def read(run):
    return run.setup_s
