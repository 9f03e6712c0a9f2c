"""How the program under test is built for a configuration, one module a
system, named by a configuration file's ``system`` key."""
