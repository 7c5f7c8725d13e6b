"""Seconds from the process's start to the window's: imports, the card's
context, inputs and weights, the program's build and load, the warm-up."""


def read(ctx):
    return ctx.setup_s
