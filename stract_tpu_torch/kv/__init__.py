from .db import Db
