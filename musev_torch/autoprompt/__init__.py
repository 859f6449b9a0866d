from .templates import generate_prompts, PortraitTemplate  # noqa: F401
