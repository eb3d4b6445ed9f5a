"""Entry points the traffic files name: ``<entry>.py`` here defines
``build(port, setting) -> solve``, where ``solve(prob, traced)`` runs one
batch through the program and returns its results (see ``l2f.py``)."""
