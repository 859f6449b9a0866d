"""Serving: shape and length guards, online inference callables, the gradio UI."""
