"""Launchers of the port: ``serve`` runs Halo's batched workflows on the
port's engines; ``train`` trains a model of the registry."""
