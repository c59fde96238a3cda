"""How the program is driven, one module a traffic ``entry``: each calls the port's own entry point."""
