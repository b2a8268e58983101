"""In-repo test models (the dense GPT) for the port."""
