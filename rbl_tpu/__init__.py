"""Former name of the ``rbl`` package, importable for a deprecation
period: every module under this name is the ``rbl`` module of the same
path."""

from rbl._alias import alias_package

alias_package(__name__, "rbl")
