"""The framework-free schedule compiler and simulator, copied from
``repro.core``: same names, same arithmetic, same iteration order, so a graph
compiles to the same taskflow and prices to the same ``SimResult`` in both
packages. Only the modules a ported path imports are here."""
