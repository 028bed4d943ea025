"""Model zoo of the port (≙ ``bigdl_tpu/models``); so far the
TransformerLM forward."""
