"""Route modules. Each exposes register(app) mounting its endpoints."""
