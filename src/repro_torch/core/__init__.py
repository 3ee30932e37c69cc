"""Graph storage, sampling, feature caching and batch assembly."""
