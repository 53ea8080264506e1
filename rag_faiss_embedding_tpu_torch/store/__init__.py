from .database import Database
