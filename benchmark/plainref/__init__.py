"""The plain reference of the benchmark's simulations.

Frozen copies of the port's plain PyTorch versions (the functions its CPU
path runs), cut to what the smoke plume's and the breaking dam's steps
need, with every floating type taken from ``prec.fdt()``. Nothing here
imports the port, and nothing here reads a table or weight the port made.
"""
