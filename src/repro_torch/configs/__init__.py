"""Model and input-shape configs and the ``--arch`` registry.

A copy of the reference's ``configs`` package (plain dataclasses), so the
port never imports the reference: :func:`base.get_config` and
:func:`base.get_reduced_config` give the same :class:`base.ModelConfig`
values as the reference's registry.
"""
