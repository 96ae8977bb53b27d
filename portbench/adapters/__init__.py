"""Adapters: one module a kind of item, named by a configuration's ``adapter``."""
