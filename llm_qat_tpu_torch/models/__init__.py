"""GPT-2 switchable-precision model: config, SP forward, inference."""
