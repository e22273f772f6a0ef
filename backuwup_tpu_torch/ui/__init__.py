"""User interfaces: status messenger, CLI, web dashboard.

Counterpart of ``backuwup_tpu/ui/__init__.py``, copied so that the port
imports nothing of the JAX package.
"""
