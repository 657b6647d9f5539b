"""The LM model zoo of the port (dense serving so far): ``lm`` (schema,
``prefill``, ``decode_step``), ``layers``, ``params``, ``model_api`` and
``convert`` (the reference's weights into the port)."""
