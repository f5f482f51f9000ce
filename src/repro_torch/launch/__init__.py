"""Launch layer of the port: the serving drivers (``decode_llm``)."""
