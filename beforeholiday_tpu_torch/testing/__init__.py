"""In-repo test models for the port: the dense GPT and BERT."""
