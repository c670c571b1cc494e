"""Runner kinds: ``runners/<kind>.py`` drives one kind of cell."""
