"""The benchmark's plain reference: Python integers and numpy only.

`hostmath` and `params` are frozen copies of the program's host oracle and
constants; `commitment` and `bls` hold the checks built on them.  Nothing
here imports the program, the JAX package or JAX.
"""
