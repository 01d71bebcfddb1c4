"""Online serving over the extraction stack (counterpart of ``stutter_tpu/serve``).

Modules are imported by their own names (``serve.server``, ``serve.classify``,
``serve.combined``, ``serve.http``), so that importing one does not import
the others.
"""
