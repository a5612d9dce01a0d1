"""The test suite: a regular package, so that ``tests`` resolves here
even where another installed package has that name."""
