"""Launch layer of the port: the training CLI (``train_sgns``), the
embedding server (``serve``) and the LLM decode driver (``decode_llm``)."""
