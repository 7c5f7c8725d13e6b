"""The general generators, one a kind of traffic (``recon``):
each reads a traffic file's parameters, makes the inputs and weights from
the seed, builds the program's entry, drives it, and judges what it made."""
