"""The SQL SELECT front end: tokenizer, parser, AST and the algebra bridge
that lowers a query into the engine's device primitives (a port of
``fugue_tpu/sql_frontend/``'s SELECT path)."""
